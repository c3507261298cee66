"""Tests for the long-segment DP engines: the host banded engines (C++ and
its NumPy mirror) and the device wavefront (`ops.wavefront`, run here on
the CPU backend), each against a brute-force Needleman-Wunsch optimum."""
import numpy as np
import pytest

from paramugsy_tpu.ops.extend import Scoring, banded_align_np, traceback_wavefront
from paramugsy_tpu.ops.native import banded_align_native
from paramugsy_tpu.ops.wavefront import (
    wavefront_align_many,
    wavefront_dirs,
    wavefront_streams,
)


def brute_nw(a, b, sc=Scoring()):
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int64)
    dp[0, :] = np.arange(m + 1) * sc.gap
    dp[:, 0] = np.arange(n + 1) * sc.gap
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = sc.match if a[i - 1] == b[j - 1] else sc.mismatch
            dp[i, j] = max(
                dp[i - 1, j - 1] + s, dp[i - 1, j] + sc.gap, dp[i, j - 1] + sc.gap
            )
    return dp[n, m]


def path_score(a, b, rg, qg, n, sc=Scoring()):
    rgm = np.zeros(n, bool)
    qgm = np.zeros(n, bool)
    for g in rg:
        rgm[g.start - 1 : g.end] = True
    for g in qg:
        qgm[g.start - 1 : g.end] = True
    ri = qi = score = 0
    for c in range(n):
        if rgm[c] or qgm[c]:
            score += sc.gap
            ri += 0 if rgm[c] else 1
            qi += 0 if qgm[c] else 1
        else:
            score += sc.match if a[ri] == b[qi] else sc.mismatch
            ri += 1
            qi += 1
    assert ri == len(a) and qi == len(b), "path does not consume both sequences"
    return score


def random_pair(seed):
    rng = np.random.default_rng(seed)
    la = int(rng.integers(5, 120))
    lb = max(la + int(rng.integers(-40, 40)), 2)
    a = rng.integers(0, 4, size=la).astype(np.int8)
    if seed % 2 == 0 and lb <= la:
        b = a[:lb].copy()
        m = rng.random(lb) < 0.1
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
    else:
        b = rng.integers(0, 4, size=lb).astype(np.int8)
    return a, b


def diverged_pairs(seed, n_pairs, lo, hi, n_del, sub):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_pairs):
        la = int(rng.integers(lo, hi))
        a = rng.integers(0, 4, size=la).astype(np.int8)
        b = np.delete(a, rng.choice(la, n_del, replace=False)).copy()
        m = rng.random(len(b)) < sub
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        pairs.append((a, b))
    return pairs


def host_banded(a, b, width):
    out = banded_align_native(a, b, width, 2, -3, -4)
    assert out is not None, "native library did not load"
    return out


class TestBandedDP:
    @pytest.mark.parametrize("seed", range(3))
    def test_optimal_when_band_covers(self, seed):
        """When the band covers the whole DP table, banded == full optimum,
        for the C++ engine and its NumPy mirror alike."""
        a, b = random_pair(seed)
        want = brute_nw(a, b)
        assert path_score(a, b, *host_banded(a, b, 256)) == want
        assert path_score(a, b, *banded_align_np(a, b, width=256)) == want

    def test_long_similar_pair(self):
        """A long diverged pair stays in-band and aligns near-perfectly."""
        rng = np.random.default_rng(99)
        la = 250
        a = rng.integers(0, 4, size=la).astype(np.int8)
        b = np.delete(a, [100, 101, 102])  # 3bp deletion
        m = rng.random(len(b)) < 0.02
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        for rg, qg, n in (host_banded(a, b, 256), banded_align_np(a, b, width=256)):
            # one query-side gap of 3, no ref gaps
            assert sum(g.length for g in qg) == 3
            assert rg == []
            assert n == la

    def test_band_violation_raises(self):
        a = np.zeros(1000, np.int8)
        b = np.zeros(10, np.int8)
        with pytest.raises(ValueError):
            banded_align_np(a, b, width=256)

    def test_empty_query(self):
        a = np.array([0, 1, 2], np.int8)
        b = np.zeros(0, np.int8)
        for rg, qg, n in (host_banded(a, b, 256), banded_align_np(a, b, width=256)):
            assert n == 3 and qg[0].length == 3 and rg == []


class TestBatchedKernel:
    def test_batch_matches_single(self):
        pairs = diverged_pairs(3, 5, 40, 200, 3, 0.05)
        batch = wavefront_align_many(pairs, base_width=256)
        for pair, got in zip(pairs, batch):
            assert got == wavefront_align_many([pair], base_width=256)[0]


class TestWavefrontKernel:
    @pytest.mark.parametrize("seed", range(4))
    def test_optimal_when_band_covers(self, seed):
        a, b = random_pair(seed)
        (res,) = wavefront_align_many([(a, b)], base_width=256)
        assert path_score(a, b, *res) == brute_nw(a, b)

    def test_matches_host_engine_on_batch(self):
        pairs = diverged_pairs(11, 6, 40, 300, 4, 0.05)
        wf = wavefront_align_many(pairs, base_width=256)
        for (a, b), got_wf in zip(pairs, wf):
            # Same optimal score (tie paths may differ between formulations).
            s_wf = path_score(a, b, *got_wf)
            s_host = path_score(a, b, *host_banded(a, b, 256))
            assert s_wf == s_host == brute_nw(a, b)

    def test_empty_query(self):
        a = np.array([0, 1, 2], np.int8)
        b = np.zeros(0, np.int8)
        (res,) = wavefront_align_many([(a, b)], base_width=256)
        rg, qg, n = res
        assert n == 3 and qg[0].length == 3 and rg == []

    def test_align_many_buckets_and_order(self):
        """wavefront_align_many returns per-pair optima in input order,
        across step buckets and batch padding."""
        rng = np.random.default_rng(21)
        segs = []
        for la in (0, 7, 30, 90, 60, 15):
            a = rng.integers(0, 4, size=la).astype(np.int8)
            if la >= 4:
                b = np.delete(a, rng.choice(la, 2, replace=False)).copy()
            else:
                b = a.copy()
            segs.append((a, b))
        many = wavefront_align_many(segs, batch=8, base_width=256, min_steps=64)
        assert len(many) == len(segs)
        assert many[0] == ([], [], 0)
        for (a, b), got in zip(segs[1:], many[1:]):
            assert path_score(a, b, *got) == brute_nw(a, b)

    def test_align_many_mid_size_part(self):
        """Dispatch groups of 9..batch//2 pairs round the launch batch UP
        to a multiple of 8 (a fixed batch of 8 would drop pairs)."""
        pairs = diverged_pairs(33, 12, 10, 60, 2, 0.0)
        many = wavefront_align_many(pairs, batch=64, base_width=256)
        assert len(many) == 12
        for (a, b), got in zip(pairs, many):
            assert path_score(a, b, *got) == brute_nw(a, b)

    def test_native_traceback_matches_reference(self):
        """The native traceback of the packed directions reproduces the
        Python reference walk on a pair long enough to span many words."""
        from paramugsy_tpu.ops.native import wavefront_traceback_native

        (pair,) = diverged_pairs(8, 1, 2000, 2001, 6, 0.02)
        a, b = pair
        steps, width = 4096, 256
        dirs = np.asarray(wavefront_dirs(*wavefront_streams([pair] * 8, steps, width)))
        want = traceback_wavefront(dirs[:, 0, :], len(a), len(b), width)
        lens = np.full(8, len(a), np.int32), np.full(8, len(b), np.int32)
        got = wavefront_traceback_native(dirs, *lens, width)
        assert got is not None, "native library did not load"
        assert got[0] == want and got[7] == want
        assert path_score(a, b, *want) == brute_nw(a, b)
