"""Where the program runs: the compile-cache directory rule, one card per
process on a shared host, and no silent fallback to another platform."""
import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from paramugsy_tpu.runtime import dist
from paramugsy_tpu.runtime.dist import local_device_ids_for
from paramugsy_tpu.utils.cache import DEFAULT_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import os, jax, jax.numpy as jnp
from paramugsy_tpu.utils.cache import enable_compilation_cache
d = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()[-2:]


def test_cache_dir_from_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is written there."""
    d = str(tmp_path / "cache")
    assert _probe(d) == [d, d]
    assert os.listdir(d), "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_cache_dir_default_is_checkout():
    """Unset, the cache goes to <checkout>/.jax_cache."""
    assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    assert _probe(None) == [DEFAULT_DIR, DEFAULT_DIR]


@pytest.mark.parametrize(
    "coordinator,nproc,pid,cards,want",
    [
        ("localhost:1234", 4, 2, 4, [2]),
        ("127.0.0.1:1234", 4, 0, 4, [0]),
        ("127.0.0.2:1234", 2, 1, 4, [1]),
        ("[::1]:1234", 4, 3, 4, [3]),
        (f"{socket.gethostname()}:1234", 2, 1, 4, [1]),
        ("localhost:1234", 8, 5, 4, [1]),  # more processes than cards
        ("192.0.2.1:1234", 4, 1, 4, None),  # not an address of this host
        ("localhost:1234", 4, None, 4, None),  # cluster manager's choice
        ("localhost:1234", 1, 0, 4, None),  # one process keeps every card
        ("localhost:1234", 4, 1, 0, None),  # no card: CPU processes
    ],
)
def test_local_device_ids(monkeypatch, coordinator, nproc, pid, cards, want):
    """Processes on one host get one card each; other hosts are JAX's."""
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    assert local_device_ids_for(coordinator, nproc, pid, cards) == want


def test_local_device_ids_env_wins(monkeypatch):
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0,1")
    assert local_device_ids_for("localhost:1234", 2, 1, 4) is None


@pytest.mark.parametrize(
    "visible,want", [("0,1,2,3", 4), ("2", 1), ("", 0), ("1,-1,2", 1)]
)
def test_local_card_count_visible(monkeypatch, visible, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert dist.local_card_count() == want


def test_init_distributed_from_env(monkeypatch):
    """The CLI calls init_distributed() with no arguments: the process id
    and count come from the environment, and the process gets its card."""
    import jax

    calls = []
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "local_card_count", lambda: 4)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    ctx = dist.init_distributed()
    assert calls == [
        dict(
            coordinator_address="localhost:1234", num_processes=4,
            process_id=2, local_device_ids=[2],
        )
    ]
    assert ctx.initialized


def test_init_distributed_without_coordinator(monkeypatch):
    import jax

    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: 1 / 0)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    ctx = dist.init_distributed()
    assert not ctx.initialized and ctx.process_count == 1


def test_cli_align_distributed_two_processes(tmp_path):
    """`cli align -distributed` as two processes configured only through
    the environment: both join the world before opening a device, split
    the pairs and merges, and write the single-process MAF (eight genomes
    with a repeat family: merge order decides gap placement there)."""
    sys.path.insert(0, ROOT)
    import bench

    family = bench.build_repeat_family(np.random.default_rng(5), 60_000, count=8)
    paths = []
    for i, g in enumerate(family):
        paths.append(str(tmp_path / f"s{i}.fa"))
        with open(paths[-1], "w") as f:
            f.write(f">s{i}.chr\n" + "".join(np.array(list("ACGT"))[g]) + "\n")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]

    def run(args, extra):
        env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
        env.pop("XLA_FLAGS", None)
        return subprocess.Popen(
            [sys.executable, "-m", "paramugsy_tpu.cli", "align", *paths, *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )

    procs = [
        run(
            ["-out_maf", str(tmp_path / f"out{i}.maf"), "-tmp_dir",
             str(tmp_path / "store"), "-distributed"],
            dict(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                 JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(i)),
        )
        for i in range(2)
    ]
    single = run(["-out_maf", str(tmp_path / "single.maf")], {})
    for i, p in enumerate(procs + [single]):
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-3000:]
        if i < 2:
            assert f"(process {i} of 2)" in out
    want = (tmp_path / "single.maf").read_text()
    assert want.count("\na ") >= 3
    for i in range(2):
        assert (tmp_path / f"out{i}.maf").read_text() == want


def test_no_platform_fallback_module():
    assert importlib.util.find_spec("paramugsy_tpu.utils.platform") is None


def test_cli_missing_platform_raises(tmp_path):
    """A requested platform that is absent fails the CLI; it does not run
    on another one."""
    env = dict(os.environ, JAX_PLATFORMS="rocm")
    r = subprocess.run(
        [sys.executable, "-m", "paramugsy_tpu.cli", "nucmer",
         "-ref_seq", str(tmp_path / "r.fa"), "-query_seq", str(tmp_path / "q.fa")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "rocm" in r.stderr and "device: cpu" not in r.stderr
