"""Tests for the on-device alignment ops (encode/seeding/chaining/extend)."""
import numpy as np
import pytest

import jax.numpy as jnp

from paramugsy_tpu.ops.encode import (
    bucket_size,
    decode,
    encode,
    kmer_codes,
    pad_to,
    revcomp_codes,
)
from paramugsy_tpu.ops.seeding import find_seeds
from paramugsy_tpu.ops.chaining import chain_clusters, cluster_seeds
from paramugsy_tpu.ops.extend import (
    Scoring,
    align_segments,
    nw_align_batch,
    traceback_gaps,
)
from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair, filter_one_to_one
from tests.util import check_delta_valid, entry_identity

_COMP = str.maketrans("ACGT", "TGCA")


def rand_dna(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(4, size=n)])


class TestEncode:
    def test_round_trip(self):
        s = "ACGTNacgtn"
        assert decode(encode(s)) == "ACGTNACGTN"

    def test_revcomp(self):
        s = "AACGTN"
        rc = decode(np.array(revcomp_codes(jnp.array(encode(s)))))
        assert rc == "NACGTT"

    def test_pad_bucket(self):
        assert bucket_size(5000) == 8192
        assert len(pad_to(encode("ACGT"), 16)) == 16

    def test_kmer_codes_brute(self):
        rng = np.random.default_rng(3)
        s = rand_dna(rng, 50)
        s = s[:20] + "N" + s[21:]
        codes = encode(s)
        k = 5
        km, valid = kmer_codes(jnp.array(codes), k)
        km, valid = np.array(km), np.array(valid)
        for i in range(len(s)):
            window = s[i : i + k]
            expect_valid = len(window) == k and "N" not in window
            assert valid[i] == expect_valid
            if expect_valid:
                code = 0
                for c in window:
                    code = (code << 2) | "ACGT".index(c)
                assert km[i] == code


def brute_unique_matches(ref, query, k):
    """All (rpos, qpos) where a ref-unique k-mer matches."""
    from collections import Counter, defaultdict

    rc = Counter(ref[i : i + k] for i in range(len(ref) - k + 1))
    rpos = {ref[i : i + k]: i for i in range(len(ref) - k + 1)}
    out = set()
    for j in range(len(query) - k + 1):
        w = query[j : j + k]
        if "N" not in w and rc.get(w) == 1:
            out.add((rpos[w], j))
    return out


class TestSeeding:
    def test_planted_match(self):
        rng = np.random.default_rng(0)
        ref = rand_dna(rng, 300)
        query = rand_dna(rng, 40) + ref[100:200] + rand_dna(rng, 40)
        out = find_seeds(jnp.array(encode(ref)), jnp.array(encode(query)), k=16, max_seeds=128)
        m = np.array(out.mask)
        rp, qp, ln = np.array(out.rpos)[m], np.array(out.qpos)[m], np.array(out.length)[m]
        found = {(int(r), int(q), int(l)) for r, q, l in zip(rp, qp, ln)}
        assert (100, 40, 100) in found

    @pytest.mark.parametrize("seed", range(4))
    def test_matches_brute_force(self, seed):
        rng = np.random.default_rng(seed)
        k = 8
        ref = rand_dna(rng, 150)
        query = rand_dna(rng, 60) + ref[30:80] + rand_dna(rng, 20)
        out = find_seeds(jnp.array(encode(ref)), jnp.array(encode(query)), k=k, max_seeds=512)
        m = np.array(out.mask)
        # expand merged runs back to raw kmer matches
        got = set()
        for r, q, l in zip(np.array(out.rpos)[m], np.array(out.qpos)[m], np.array(out.length)[m]):
            for off in range(int(l) - k + 1):
                got.add((int(r) + off, int(q) + off))
        expect = brute_unique_matches(ref, query, k)
        assert got == expect

    def test_exactness(self):
        rng = np.random.default_rng(9)
        ref = rand_dna(rng, 400)
        query = rand_dna(rng, 50) + ref[100:220] + rand_dna(rng, 50)
        out = find_seeds(jnp.array(encode(ref)), jnp.array(encode(query)), k=16, max_seeds=256)
        m = np.array(out.mask)
        for r, q, l in zip(np.array(out.rpos)[m], np.array(out.qpos)[m], np.array(out.length)[m]):
            assert ref[r : r + l] == query[q : q + l]


class TestClusterChain:
    def test_cluster_two_diagonals(self):
        # seeds on two far-apart diagonals -> two clusters
        rpos = jnp.array([10, 40, 70, 500, 530], dtype=jnp.int32)
        qpos = jnp.array([10, 40, 70, 100, 130], dtype=jnp.int32)
        length = jnp.array([20, 20, 20, 20, 20], dtype=jnp.int32)
        mask = jnp.ones(5, dtype=bool)
        cl = cluster_seeds(rpos, qpos, length, mask, band=16, max_gap=90, max_clusters=8)
        n = int(cl.n_clusters)
        assert n == 2
        cm = np.array(cl.c_mask)
        w = np.array(cl.c_weight)[cm][:n]
        assert sorted(w.tolist()) == [40, 60]

    def test_chain_clusters_joins(self):
        # two clusters on nearly the same diagonal, small gap -> one chain
        chains = chain_clusters(
            np.array([0, 100]), np.array([89, 189]),
            np.array([0, 102]), np.array([89, 191]),
            np.array([90, 90]),
        )
        assert chains == [[0, 1]]

    def test_chain_clusters_break(self):
        chains = chain_clusters(
            np.array([0, 10000]), np.array([89, 10089]),
            np.array([0, 102]), np.array([89, 191]),
            np.array([90, 90]),
        )
        assert sorted(chains) == [[0], [1]]


def brute_nw(a, b, scoring=Scoring()):
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=np.int64)
    dp[0, :] = np.arange(m + 1) * scoring.gap
    dp[:, 0] = np.arange(n + 1) * scoring.gap
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = scoring.match if a[i - 1] == b[j - 1] else scoring.mismatch
            dp[i, j] = max(dp[i - 1, j - 1] + s, dp[i - 1, j] + scoring.gap, dp[i, j - 1] + scoring.gap)
    return dp[n, m]


class TestExtend:
    @pytest.mark.parametrize("seed", range(5))
    def test_optimal_score(self, seed):
        rng = np.random.default_rng(seed)
        a = encode(rand_dna(rng, int(rng.integers(3, 14))))
        b = encode(rand_dna(rng, int(rng.integers(3, 14))))
        S = 16
        A = np.full((1, S), 4, np.int8); A[0, : len(a)] = a
        Bm = np.full((1, S), 4, np.int8); Bm[0, : len(b)] = b
        dirs, _ = nw_align_batch(A, np.array([len(a)]), Bm, np.array([len(b)]))
        rg, qg, n = traceback_gaps(dirs[0], len(a), len(b))
        # path consistency
        n_ref_gap = sum(g.length for g in rg)
        n_query_gap = sum(g.length for g in qg)
        assert n == len(a) + n_ref_gap
        assert n == len(b) + n_query_gap
        # score of traced path == optimal score
        score = 0
        ri = qi = 0
        rgm = np.zeros(n, bool)
        for g in rg: rgm[g.start - 1 : g.end] = True
        qgm = np.zeros(n, bool)
        for g in qg: qgm[g.start - 1 : g.end] = True
        sc = Scoring()
        for c in range(n):
            if rgm[c] or qgm[c]:
                score += sc.gap
                ri += 0 if rgm[c] else 1
                qi += 0 if qgm[c] else 1
            else:
                score += sc.match if a[ri] == b[qi] else sc.mismatch
                ri += 1
                qi += 1
        assert score == brute_nw(a, b)

    def test_align_segments_degenerate(self):
        out = align_segments([
            (encode(""), encode("")),
            (encode(""), encode("ACG")),
            (encode("ACG"), encode("")),
        ])
        assert out[0] == ([], [], 0)
        assert out[1][0][0].length == 3 and out[1][2] == 3
        assert out[2][1][0].length == 3

    def test_align_segments_spans_matches_slices(self):
        """The span-array fast path (native pm_nw_segments) must be
        indistinguishable from aligning the corresponding slices."""
        from paramugsy_tpu.ops.extend import align_segments_spans

        rng = np.random.default_rng(11)
        ref = rng.integers(0, 4, 4000).astype(np.int8)
        qry = rng.integers(0, 4, 4000).astype(np.int8)
        r0l, r1l, q0l, q1l = [], [], [], []
        for _ in range(300):
            a = int(rng.integers(0, 3900))
            la = int(rng.integers(0, 50))
            b = int(rng.integers(0, 3900))
            lb = max(0, la + int(rng.integers(-4, 5)))
            r0l.append(a), r1l.append(a + la), q0l.append(b), q1l.append(b + lb)
        r0, r1 = np.array(r0l), np.array(r1l)
        q0, q1 = np.array(q0l), np.array(q1l)
        ncols, gapped = align_segments_spans(ref, qry, r0, r1, q0, q1)
        want = align_segments(
            [(ref[a:b], qry[c:d]) for a, b, c, d in zip(r0, r1, q0, q1)]
        )
        for t, (rg, qg, nc) in enumerate(want):
            assert ncols[t] == nc
            got = gapped.get(t, ([], []))
            assert list(got[0]) == rg and list(got[1]) == qg

    def test_align_segments_spans_redo_paths(self):
        """Exercise both in-band redo markers of pm_nw_segments (ADVICE
        r3): -1 (segment longer than the 4096 cap -> long-segment engine)
        and -2 (gap-run overflow -> solo realign)."""
        from paramugsy_tpu.ops.extend import align_segments_spans

        rng = np.random.default_rng(23)
        # Over-cap segment: 5000 bp vs a 4990 bp copy with 10 deletions.
        long_a = rng.integers(0, 4, 5000).astype(np.int8)
        long_b = np.delete(long_a, rng.choice(5000, 10, replace=False))
        # Run-overflow segment: 40 random 3-bp blocks, each followed by an
        # extra base on the ref side only -> ~40 separate 1-bp query-gap
        # runs, far beyond max_runs=34.
        blocks_b, blocks_a = [], []
        for _ in range(40):
            blk = rng.integers(0, 4, 3).astype(np.int8)
            blocks_b.append(blk)
            blocks_a.append(np.concatenate([blk, rng.integers(0, 4, 1).astype(np.int8)]))
        ovf_a = np.concatenate(blocks_a)
        ovf_b = np.concatenate(blocks_b)
        # One ordinary segment so the batch is mixed.
        mid = rng.integers(0, 4, 30).astype(np.int8)
        ref = np.concatenate([long_a, ovf_a, mid])
        qry = np.concatenate([long_b, ovf_b, mid])
        o_r = [0, len(long_a), len(long_a) + len(ovf_a)]
        o_q = [0, len(long_b), len(long_b) + len(ovf_b)]
        r0 = np.array(o_r)
        r1 = np.array([o_r[0] + len(long_a), o_r[1] + len(ovf_a), o_r[2] + len(mid)])
        q0 = np.array(o_q)
        q1 = np.array([o_q[0] + len(long_b), o_q[1] + len(ovf_b), o_q[2] + len(mid)])
        ncols, gapped = align_segments_spans(ref, qry, r0, r1, q0, q1)
        want = align_segments(
            [(ref[a:b], qry[c:d]) for a, b, c, d in zip(r0, r1, q0, q1)]
        )
        assert len(want[1][0]) + len(want[1][1]) > 34  # really overflows
        for t, (rg, qg, nc) in enumerate(want):
            assert ncols[t] == nc
            got = gapped.get(t, ([], []))
            assert list(got[0]) == rg and list(got[1]) == qg


class TestAlignPair:
    def setup_method(self):
        rng = np.random.default_rng(7)
        n = 6000
        self.ref = rand_dna(rng, n)
        q = list(self.ref)
        for i in rng.choice(n, 60, replace=False):
            q[i] = "ACGT"[rng.integers(4)]
        qs = "".join(q)
        qs = qs[:2000] + qs[2010:]              # deletion
        qs = qs[:3000] + "ACGTACGTAC" + qs[3000:]  # insertion
        inv = qs[4000:4800].translate(_COMP)[::-1]
        self.query = qs[:4000] + inv + qs[4800:]

    def test_recovers_structure(self):
        entries = align_pair(self.ref, self.query, "R.c", "Q.c")
        assert entries
        for e in entries:
            check_delta_valid(e)
            ident = entry_identity(e, self.ref, self.query)
            assert ident > 0.95, f"low identity {ident}"
        # coverage of ref
        covered = np.zeros(len(self.ref), bool)
        n_rev = 0
        for e in entries:
            r = e.ref_range.abs()
            covered[r.start - 1 : r.end] = True
            n_rev += not e.query_range.is_forward
        assert covered.mean() > 0.9, f"ref coverage {covered.mean()}"
        assert n_rev >= 1, "inversion not found on reverse strand"

    def test_filter_one_to_one(self):
        entries = align_pair(self.ref, self.query, "R.c", "Q.c")
        kept = filter_one_to_one(entries)
        assert kept
        # non-overlapping on ref
        last = 0
        for e in kept:
            assert e.ref_range.abs().start > last
            last = e.ref_range.abs().end

    def test_filter_one_to_one_is_optimal(self):
        """Per-axis selection is exact weighted interval scheduling: chosen
        weight beats (or equals) the heaviest-first greedy on random inputs
        and matches a hand-solved fixture where greedy is suboptimal."""
        from paramugsy_tpu.coords.range import Range
        from paramugsy_tpu.formats.delta import DeltaEntry
        from paramugsy_tpu.ops.align_pair import _wis_filter

        def mk(s, e):
            return DeltaEntry(
                ref_name="r", query_name="q", ref_len=10**6, query_len=10**6,
                ref_range=Range(s, e), query_range=Range(s, e),
                ref_gaps=[], query_gaps=[],
            )

        def greedy(es, key):
            by_weight = sorted(range(len(es)), key=lambda i: -key(es[i]).length)
            chosen = []
            for i in by_weight:
                r = key(es[i]).abs()
                if all(r.end < s or r.start > e for s, e, _ in chosen):
                    chosen.append((r.start, r.end, i))
            return [es[i] for _, _, i in sorted(chosen)]

        # Fixture: one heavy interval [1,100] (w=100) vs two lighter ones
        # [1,60] + [61,120] (w=120 total).  Greedy picks the heavy one.
        es = [mk(1, 100), mk(1, 60), mk(61, 120)]
        key = lambda e: e.ref_range
        opt = _wis_filter(es, key)
        assert sum(key(e).length for e in opt) == 120
        assert sum(key(e).length for e in greedy(es, key)) == 100

        rng = np.random.default_rng(17)
        for _ in range(40):
            es = []
            for _ in range(int(rng.integers(1, 40))):
                s = int(rng.integers(1, 5000))
                e = s + int(rng.integers(0, 800))
                es.append(mk(s, e))
            w_opt = sum(key(e).length for e in _wis_filter(es, key))
            w_greedy = sum(key(e).length for e in greedy(es, key))
            assert w_opt >= w_greedy
            # chosen set must be non-overlapping
            last = 0
            for e in sorted(
                _wis_filter(es, key), key=lambda e: e.ref_range.abs().start
            ):
                assert e.ref_range.abs().start > last
                last = e.ref_range.abs().end

    def test_identical_sequences(self):
        entries = align_pair(self.ref, self.ref, "A.c", "B.c")
        best = max(entries, key=lambda e: e.alignment_length())
        assert best.ref_range == best.query_range.abs() or best.ref_range == best.query_range
        assert entry_identity(best, self.ref, self.ref) == 1.0
        assert best.alignment_length() >= len(self.ref) * 0.99


class TestEngineSelection:
    def test_native_engines_actually_run(self):
        """With libpm_native.so present, the native engines must be the
        ones that execute (a broken fast path must not silently degrade
        to NumPy — VERDICT r1 weak #5)."""
        from paramugsy_tpu.ops import engines
        from paramugsy_tpu.ops.encode import encode
        from paramugsy_tpu.ops.extend import align_segments
        from paramugsy_tpu.ops.native import load

        if load() is None:
            import pytest

            pytest.skip("native library unavailable in this environment")
        engines.reset_counts()
        rng = np.random.default_rng(5)
        short = encode(rand_dna(rng, 300))
        long_a = encode(rand_dna(rng, 6000))
        long_b = np.delete(long_a, rng.choice(6000, 10, replace=False)).copy()
        align_segments([(short, short[:290]), (long_a, long_b)])
        assert engines.COUNTS.get("native-nw", 0) >= 1
        # on CPU the long segment routes to the host banded engine
        assert engines.COUNTS.get("native-banded", 0) >= 1
        assert "numpy-nw" not in engines.COUNTS
        assert "numpy-banded" not in engines.COUNTS


    def test_native_chaining_matches_numpy(self, monkeypatch):
        """The C++ chain DP is bit-equal to the NumPy reference loop."""
        from paramugsy_tpu.ops import native
        from paramugsy_tpu.ops.chaining import chain_clusters

        if native.load() is None:
            import pytest

            pytest.skip("native library unavailable")
        rng = np.random.default_rng(3)
        for _ in range(15):
            C = int(rng.integers(1, 150))
            rs = np.sort(rng.integers(0, 5000, C))
            ln = rng.integers(20, 300, C)
            re_ = rs + ln
            qs = rs + rng.integers(-50, 50, C)
            qe = qs + ln
            w = ln.copy()
            got = chain_clusters(
                rs, re_, qs, qe, w, max_join_gap=200, min_chain_weight=65
            )
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", True)
            want = chain_clusters(
                rs, re_, qs, qe, w, max_join_gap=200, min_chain_weight=65
            )
            monkeypatch.undo()
            assert got == want


class TestLongSegments:
    def test_long_segment_banded_fallback(self):
        from paramugsy_tpu.ops.extend import align_segments
        from paramugsy_tpu.ops.encode import encode

        rng = np.random.default_rng(4)
        a = encode(rand_dna(rng, 6000))
        b = np.delete(a, rng.choice(6000, 30, replace=False)).copy()
        m = rng.random(len(b)) < 0.01
        b[m] = ((b[m] + 1) % 4).astype(np.int8)
        out = align_segments([(a, b)])
        rg, qg, n = out[0]
        assert n == 6000
        assert rg == []
        assert sum(g.length for g in qg) == 30

    def test_banded_np_matches_full_dp(self):
        from paramugsy_tpu.ops.extend import Scoring, banded_align_np
        from tests.test_dp import brute_nw, path_score

        rng = np.random.default_rng(11)
        a = rng.integers(0, 4, size=90).astype(np.int8)
        b = rng.integers(0, 4, size=70).astype(np.int8)
        rg, qg, n = banded_align_np(a, b, width=256)
        assert path_score(a, b, rg, qg, n) == brute_nw(a, b)


class TestAlignSelf:
    """Duplication detection: genome-vs-self repeat alignment."""

    def _genome(self, seed=3, n=20000):
        rng = np.random.default_rng(seed)
        g = rng.integers(0, 4, size=n).astype(np.int8)
        g[12000:13000] = g[2000:3000]              # direct duplication
        g[16000:16600] = (3 - g[5000:5600])[::-1]  # inverted duplication
        return g

    def test_finds_planted_duplications(self):
        from paramugsy_tpu.ops.align_pair import align_self
        from paramugsy_tpu.ops.encode import decode

        g = self._genome()
        entries = align_self(g, "G.c")
        assert entries
        txt = decode(g)
        direct = [e for e in entries if e.query_range.is_forward]
        inverted = [e for e in entries if not e.query_range.is_forward]
        assert len(direct) == 1 and len(inverted) == 1
        d, v = direct[0], inverted[0]
        # Coordinates cover the planted copies (extension may add a few
        # chance-matching flank bases).
        assert d.ref_range.start <= 2001 and d.ref_range.end >= 3000
        assert d.query_range.start <= 12001 and d.query_range.end >= 13000
        assert v.ref_range.abs().start <= 5001 and v.ref_range.abs().end >= 5600
        assert v.query_range.abs().start <= 16001 and v.query_range.abs().end >= 16600
        for e in entries:
            check_delta_valid(e)
            assert entry_identity(e, txt, txt) > 0.95
            # canonical: copy1 starts before copy2, never identity
            assert e.ref_range.abs().start < e.query_range.abs().start

    def test_no_false_duplications_in_random_sequence(self):
        from paramugsy_tpu.ops.align_pair import align_self

        rng = np.random.default_rng(11)
        g = rng.integers(0, 4, size=20000).astype(np.int8)
        entries = [e for e in align_self(g, "G.c") if e.alignment_length() >= 65]
        assert entries == []

    def test_three_copy_repeat_chains_adjacent(self):
        from paramugsy_tpu.ops.align_pair import align_self

        rng = np.random.default_rng(5)
        g = rng.integers(0, 4, size=16000).astype(np.int8)
        g[6000:6500] = g[1000:1500]
        g[11000:11500] = g[1000:1500]
        entries = align_self(g, "G.c")
        pairs = {
            (e.ref_range.start // 100, e.query_range.abs().start // 100)
            for e in entries
        }
        # adjacent-occurrence pairing: (c1,c2) and (c2,c3)
        assert (10, 60) in pairs and (60, 110) in pairs


class TestWindowedAlignment:
    """Sequence-axis decomposition: contigs beyond the seeding window are
    cut into overlapping windows; every locus reported by exactly one
    window pair (midpoint-in-core rule)."""

    def _pair(self, n=60000, seed=4):
        rng = np.random.default_rng(seed)
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.01
        q[m] = ((q[m] + 1) % 4).astype(np.int8)
        q = np.concatenate([q[:20000], q[20020:]])
        a, b = 35000, 41000
        q = np.concatenate([q[:a], (3 - q[a:b])[::-1], q[b:]])
        return ref, q

    def test_same_coverage_as_unwindowed(self):
        from paramugsy_tpu.ops.encode import decode

        ref, q = self._pair()
        base = align_pair(ref, q, "R.c", "Q.c", AlignConfig())
        wcfg = AlignConfig(window=1 << 14, window_overlap=1 << 12)
        win = align_pair(ref, q, "R.c", "Q.c", wcfg)

        def cov(entries):
            c = np.zeros(len(ref), bool)
            for e in entries:
                r = e.ref_range.abs()
                c[r.start - 1 : r.end] = True
            return c

        assert (cov(win) == cov(base)).all()
        assert sum(not e.query_range.is_forward for e in win) >= 1
        rt, qt = decode(ref), decode(q)
        keys = set()
        for e in win:
            check_delta_valid(e)
            assert entry_identity(e, rt, qt) > 0.95
            k = (e.ref_range.start, e.ref_range.end,
                 e.query_range.start, e.query_range.end)
            assert k not in keys
            keys.add(k)

    def test_boundary_spanning_alignment_is_one_entry(self):
        """An alignment crossing a window boundary must come out as ONE
        delta entry (VERDICT r3 #6): pieces from adjacent window pairs are
        de-overlapped and fused, matching the unwindowed shape."""
        from paramugsy_tpu.ops.encode import decode

        rng = np.random.default_rng(9)
        n = 60000
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.01
        q[m] = ((q[m] + 1) % 4).astype(np.int8)
        base = align_pair(ref, q, "R.c", "Q.c", AlignConfig())
        wcfg = AlignConfig(window=1 << 14, window_overlap=1 << 12)
        win = align_pair(ref, q, "R.c", "Q.c", wcfg)
        # The clean SNP-only pair is one collinear alignment end to end;
        # windowing (4 boundaries) must not fragment it.
        assert len(base) == 1
        assert len(win) == 1
        e = win[0]
        check_delta_valid(e)
        assert e.ref_range.abs().start <= 20
        assert e.ref_range.abs().end >= n - 20
        assert entry_identity(e, decode(ref), decode(q)) > 0.95

    def test_windowed_matches_unwindowed_entry_structure(self):
        """With indels + an inversion, windowed entry count equals the
        unwindowed count (pieces re-fused, nothing spuriously merged)."""
        ref, q = self._pair()
        base = align_pair(ref, q, "R.c", "Q.c", AlignConfig())
        wcfg = AlignConfig(window=1 << 14, window_overlap=1 << 12)
        win = align_pair(ref, q, "R.c", "Q.c", wcfg)

        def norm(es):
            return sorted(
                (e.ref_range.abs().start // 50, e.ref_range.abs().end // 50,
                 e.query_range.is_forward)
                for e in es
            )

        assert norm(win) == norm(base)

    def test_windowed_post_filter_applies_globally(self):
        ref, q = self._pair()
        wcfg = AlignConfig(
            window=1 << 14, window_overlap=1 << 12, post_filter="one_to_one"
        )
        win = align_pair(ref, q, "R.c", "Q.c", wcfg)
        last = 0
        for e in win:
            assert e.ref_range.abs().start > last
            last = e.ref_range.abs().end

    def test_windowed_align_self(self):
        from paramugsy_tpu.ops.align_pair import align_self

        rng = np.random.default_rng(3)
        n = 60000
        g = rng.integers(0, 4, size=n).astype(np.int8)
        g[40000:41000] = g[2000:3000]
        g[52000:52600] = (3 - g[5000:5600])[::-1]
        g[21000:21400] = g[20000:20400]
        base = align_self(g, "G.c", AlignConfig())
        win = align_self(
            g, "G.c", AlignConfig(window=1 << 14, window_overlap=1 << 12)
        )

        def norm(es):
            return sorted(
                (e.ref_range.abs().start // 50,
                 e.query_range.abs().start // 50,
                 e.query_range.is_forward)
                for e in es if e.alignment_length() >= 100
            )

        assert norm(base) == norm(win)


class TestSeedOverflowRetry:
    def test_tiny_bucket_converges_to_full_result(self):
        rng = np.random.default_rng(8)
        n = 50000
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.02
        q[m] = ((q[m] + 1) % 4).astype(np.int8)
        small = align_pair(ref, q, "R.c", "Q.c", AlignConfig(max_seeds=1 << 8))
        full = align_pair(ref, q, "R.c", "Q.c", AlignConfig(max_seeds=1 << 16))

        def tot(es):
            return sum(e.ref_range.length for e in es)

        assert abs(tot(small) - tot(full)) < n * 0.01

    def test_cap_stops_retries(self):
        rng = np.random.default_rng(9)
        n = 20000
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        # cap below need: must still return (possibly truncated), not loop
        cfg = AlignConfig(max_seeds=1 << 6, max_seeds_cap=1 << 7)
        entries = align_pair(ref, q, "R.c", "Q.c", cfg)
        assert entries


class TestSampledEndExtension:
    """Sampled seeding bounds runs at the outermost SAMPLED k-mer; the
    maximal end extension in _entries_of_chain must recover the true
    match ends (nucmer matches are maximal), or every entry sheds 1-2^shift
    bp of unique sliver at each end (measured: 40 scrap blocks around one
    500 kb 16-way block before the fix)."""

    def test_sampled_matches_exact_on_snp_pair(self):
        import dataclasses

        from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair

        rng = np.random.default_rng(23)
        n = 60_000
        ref = rand_dna(rng, n)
        q = list(ref)
        for i in rng.choice(n, n // 100, replace=False):
            q[i] = "ACGT"[rng.integers(4)]
        query = "".join(q)
        base = AlignConfig()
        exact = align_pair(
            ref, query, "r.c", "q.c",
            dataclasses.replace(base, seed_sample_shift=0),
        )
        sampled = align_pair(
            ref, query, "r.c", "q.c",
            dataclasses.replace(base, seed_sample_shift=2),
        )
        assert [
            (e.ref_range, e.query_range) for e in sampled
        ] == [(e.ref_range, e.query_range) for e in exact]
        # ends must reach the true maximal match boundaries
        assert sampled[0].ref_range.start == exact[0].ref_range.start
        assert sampled[-1].ref_range.end == exact[-1].ref_range.end

    def test_extend_helpers(self):
        from paramugsy_tpu.ops.align_pair import _extend_left, _extend_right

        ref = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
        qry = np.array([3, 1, 2, 3, 0, 1, 2, 0], np.int8)
        # positions 1..6 agree; extending left of (4, 4) crosses 3 bases
        assert _extend_left(ref, qry, 4, 4) == 3
        assert _extend_right(ref, qry, 4, 4) == 2  # stops before idx 7
        assert _extend_left(ref, qry, 0, 0) == 0
        assert _extend_right(ref, qry, 7, 7) == 0
        # N codes (4) never extend
        refn = np.array([4, 0, 1], np.int8)
        qryn = np.array([4, 0, 1], np.int8)
        assert _extend_left(refn, qryn, 1, 1) == 0

    @pytest.mark.parametrize(
        "columns,want",
        [
            ("MMMX", 3),  # the exact run
            ("XMMMMMM", 7),  # one mismatch, then 6 matches: gain 9
            ("XMMMMM", 0),  # 5 matches gain only 7
            ("MMXMM", 2),  # a chance match past the run does not count
            ("MMXMMMMMMXXXXXMMMMMMMMMM", 9),  # X-drop ends the walk
            ("NMMMMMMM", 8),  # N scores as a mismatch
            ("", 0),
        ],
    )
    def test_ungapped_extension(self, columns, want):
        """Outward columns: M match, X mismatch, N an N in both."""
        from paramugsy_tpu.ops.align_pair import _ungapped_extension
        from paramugsy_tpu.ops.extend import Scoring

        a = np.array([{"M": 0, "X": 0, "N": 4}[c] for c in columns], np.int8)
        b = np.array([{"M": 0, "X": 1, "N": 4}[c] for c in columns], np.int8)
        assert _ungapped_extension(a, b, Scoring()) == want

    def test_entry_end_crosses_substitution(self):
        """A substitution 10 bp before a homology's end (an inversion or
        indel boundary) does not cut the entry there: the entry reaches
        the end, as nucmer's does."""
        from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair

        rng = np.random.default_rng(3)
        n, end = 30_000, 20_000
        ref = rng.integers(0, 4, n).astype(np.int8)
        q = ref.copy()
        q[end:] = (ref[end:] + 1) % 4  # every base past the end differs
        q[end - 10] = (ref[end - 10] + 2) % 4
        (e,) = align_pair(ref, q, "r", "q", AlignConfig())
        assert (e.ref_range.start, e.ref_range.end) == (1, end)
        assert (e.query_range.start, e.query_range.end) == (1, end)


def brute_sampled_matches(ref, query, k, shift):
    """(rpos, qpos, reverse) of every content-sampled canonical k-mer match
    whose canonical k-mer occurs once in the ref (on either strand);
    reverse matches in revcomp (strand-local) query coordinates."""
    from collections import Counter

    from paramugsy_tpu.ops.encode import encode

    def canonical(seq):
        codes = encode(seq).astype(np.uint64)
        n = len(codes) - k + 1
        fwd = np.zeros(n, np.uint64)
        rc = np.zeros(n, np.uint64)
        for j in range(k):
            b = codes[j : j + n]
            fwd = (fwd << np.uint64(2)) | b
            rc |= (np.uint64(3) - b) << np.uint64(2 * j)
        canon = np.minimum(fwd, rc)
        h = (canon * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
        return canon, rc < fwd, (h >> np.uint64(32 - shift)) == 0

    rc_, rs, _ = canonical(ref)
    qc, qs, qkeep = canonical(query)
    count = Counter(rc_.tolist())
    where = {c: i for i, c in enumerate(rc_.tolist())}
    out = set()
    for j in np.flatnonzero(qkeep).tolist():
        c = int(qc[j])
        if count.get(c) == 1:
            i = where[c]
            rev = bool(rs[i] != qs[j])
            out.add((i, len(query) - j - k if rev else j, rev))
    return out


def sampled_seeds_vs_brute(device=None):
    """find_seeds_both with sampling (scatter compaction) on `device`,
    expanded to k-mer matches, and the brute-force sampled matches."""
    import jax
    import jax.numpy as jnp

    from paramugsy_tpu.ops.encode import encode
    from paramugsy_tpu.ops.seeding import find_seeds_both

    rng = np.random.default_rng(41)
    n, k, shift = 30_000, 15, 2
    ref = rand_dna(rng, n)
    q = list(ref)
    for i in rng.choice(n, n // 100, replace=False):
        q[i] = "ACGT"[rng.integers(4)]
    # a reverse-strand stretch, so both strands carry matches
    comp = str.maketrans("ACGT", "TGCA")
    q = "".join(q)
    q = q[:20_000] + q[20_000:22_000].translate(comp)[::-1] + q[22_000:]
    r_dev, q_dev = (jax.device_put(jnp.asarray(encode(x)), device) for x in (ref, q))
    out = find_seeds_both(
        r_dev, q_dev, jnp.int32(n),
        k=k, max_seeds=8192, sample_shift=shift, merge_gap=0,
    )
    assert int(out.samp_over) == 0
    assert 0 < int(out.n_runs) <= 8192
    m = np.asarray(out.mask)
    got = set()
    for r, qp, ln, rev in zip(
        *(np.asarray(x)[m].tolist() for x in (out.rpos, out.qpos, out.length, out.reverse))
    ):
        got.update((r + o, qp + o, bool(rev)) for o in range(ln - k + 1))
    want = brute_sampled_matches(ref, q, k, shift)
    assert any(rev for _, _, rev in want)
    return got, want


class TestCompactionForms:
    def test_slice_equals_scatter(self):
        """The sampling compaction (scatter the kept k-mers into a
        prefix, then sort; it replaced a sort-then-slice form) keeps
        exactly the sampled brute-force matches on both strands."""
        got, want = sampled_seeds_vs_brute()
        assert got == want


class TestTransferSliceOverflow:
    def test_sliced_output_overflow_refetches_full(self, monkeypatch):
        """When the m_out/c_out output slice is too small for the pair's
        valid seeds, the per-strand n_valid counts must trigger a
        full-size refetch — entries identical to the unsliced path."""
        import paramugsy_tpu.ops.align_pair as ap

        rng = np.random.default_rng(11)
        n = 60_000
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.01
        q[m] = ((q[m] + 1) % 4).astype(np.int8)
        # force sampling so transfer_slice applies; small merge gap keeps
        # many separate runs alive (pressure on the seed slice)
        cfg = ap.AlignConfig(seed_sample_shift=2, seed_merge_gap=4)
        want = ap.align_pair(ref, q, "r", "q", cfg)
        assert want, "fixture must align"

        monkeypatch.setattr(ap, "transfer_slice", lambda *a: (16, 8))
        got = ap.align_pair(ref, q, "r", "q", cfg)
        assert [
            (e.ref_range, e.query_range, e.ref_gaps, e.query_gaps)
            for e in got
        ] == [
            (e.ref_range, e.query_range, e.ref_gaps, e.query_gaps)
            for e in want
        ]

    def test_cluster_bucket_overflow_terminates(self):
        """Full-size output that is still 'truncated' (the cluster-summary
        bucket itself overflowed) must break with the top summaries, not
        refetch forever (code-review r5: the refetch branch must only
        fire for the m_out/c_out slice)."""
        import paramugsy_tpu.ops.align_pair as ap

        rng = np.random.default_rng(3)
        n = 60_000
        ref = rng.integers(0, 4, size=n).astype(np.int8)
        q = ref.copy()
        m = rng.random(n) < 0.01
        q[m] = ((q[m] + 1) % 4).astype(np.int8)
        cfg = ap.AlignConfig(
            seed_sample_shift=2, seed_merge_gap=4, max_clusters=8
        )
        got = ap.align_pair(ref, q, "r", "q", cfg)  # must terminate
        assert isinstance(got, list)
