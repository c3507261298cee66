"""Tests that need an NVIDIA GPU: each compares the card's result with the
CPU backend or a host reference.  They skip elsewhere; on the card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]


def _pair(seed, n):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = ref.copy()
    subs = rng.random(n) < 0.01
    q[subs] = (q[subs] + 1) % 4
    return ref, q


def test_seed_cluster_gpu_equals_cpu(gpu):
    import jax
    import jax.numpy as jnp

    from paramugsy_tpu.ops.seeding import seed_cluster_both_packed

    ref, q = _pair(1, 200_000)
    out = {}
    for dev in (gpu, jax.devices("cpu")[0]):
        r, qq = (jax.device_put(jnp.asarray(x), dev) for x in (ref, q))
        ql = jax.device_put(jnp.int32(len(q)), dev)
        out[dev.platform] = np.asarray(
            seed_cluster_both_packed(
                r, qq, None, ql, k=15, max_seeds=4096, sample_shift=2
            )
        )
    np.testing.assert_array_equal(out["gpu"], out["cpu"])


def test_sampled_seeds_gpu_equal_brute(gpu):
    from tests.test_ops import sampled_seeds_vs_brute

    got, want = sampled_seeds_vs_brute(gpu)
    assert got == want


def test_jaccard_exact_on_gpu(gpu):
    import jax

    from paramugsy_tpu.tree.distance import intersection_matrix, jaccard_matrix

    rng = np.random.default_rng(2)
    s = (rng.random((6, 1 << 16)) < 0.3).astype(np.float32)
    inter = s @ s.T
    got = np.asarray(intersection_matrix(jax.device_put(s, gpu)))
    np.testing.assert_array_equal(got, inter)
    sizes = np.diag(inter).astype(np.float64)
    union = sizes[:, None] + sizes[None, :] - inter
    np.testing.assert_array_equal(
        jaccard_matrix(jax.device_put(s, gpu)), inter / np.maximum(union, 1.0)
    )


def test_wavefront_gpu_equals_host(gpu):
    import jax

    from paramugsy_tpu.ops.extend import align_long_segment
    from paramugsy_tpu.ops.wavefront import wavefront_align_many

    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(8):
        a = rng.integers(0, 4, size=3000).astype(np.int8)
        b = np.delete(a, rng.choice(3000, 10, replace=False))
        pairs.append((a, b))
    with jax.default_device(gpu):
        got = wavefront_align_many(pairs)
    assert got == [align_long_segment(a, b) for a, b in pairs]
