"""Exact-match seeding on device (the nucmer MUM-seeding role).

Replaces the external suffix-tree ``nucmer`` seeder with a sort-join over
packed k-mers, built from sorts and scans that XLA compiles for any
backend: one
``lax.sort`` over the concatenated k-mer streams, then segment reductions
expressed as cumulative sums/maxes over the sorted order (no scatters, no
data-dependent shapes).  Matches are then merged along diagonals into
maximal runs (a run of m consecutive matching k-mers is an exact match of
length m+k-1), reproducing nucmer's seed set semantics:

* ``mumreference`` (nucmer default, used by the reference pipeline via
  plain ``nucmer``: lib/nucmer/mugsy_nucmer.ml:96-116): seeds unique in the
  reference;
* ``mum``: unique in both genomes.

All outputs are fixed-size arrays with validity masks; overflow is reported
via counts so callers can re-bucket.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from paramugsy_tpu.ops.encode import kmer_codes

BIG = np.int32(2**31 - 1)  # NumPy: importing this module opens no device


class SeedMatches(NamedTuple):
    """Maximal exact matches (device arrays, fixed size, masked)."""

    rpos: jnp.ndarray  # int32 [M] 0-based ref start
    qpos: jnp.ndarray  # int32 [M] 0-based query start
    length: jnp.ndarray  # int32 [M] match length in bases
    mask: jnp.ndarray  # bool  [M]
    n_raw: jnp.ndarray  # int32 [] raw unique-kmer matches before merging
    n_runs: jnp.ndarray  # int32 [] merged runs (may exceed M: overflow)


def _suffix_min(x):
    return lax.cummin(x, axis=0, reverse=True)


def _prefix_max(x):
    return lax.cummax(x, axis=0)


def _carry_last_marked(mark, payload):
    """Per element: the payload at the most recent marked position
    (inclusive), and whether any marked position has been seen.

    The gather-free replacement for ``x[prefix_max(where(mark, idx, -1))]``:
    an inclusive Hillis-Steele scan of the associative take-right-if-marked
    operator, written as an explicit doubling loop — a flat log2(n) ladder
    of pad/slice + select.  (Whether ``lax.associative_scan`` is faster on
    the GPU is an open A/B.)
    Payloads may be any int32 values (no monotonicity requirement,
    unlike the prefix-max tricks).
    """
    n = mark.shape[0]
    m = mark.astype(jnp.int32)
    p = payload
    sh = 1
    while sh < n:
        m_prev = jnp.concatenate([jnp.zeros(sh, m.dtype), m[:-sh]])
        p_prev = jnp.concatenate([jnp.zeros(sh, p.dtype), p[:-sh]])
        p = jnp.where(m != 0, p, p_prev)
        m = m | m_prev
        sh *= 2
    return m != 0, p


@functools.partial(jax.jit, static_argnames=("k", "max_seeds", "unique_in_query"))
def find_seeds(
    ref_codes,
    query_codes,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
) -> SeedMatches:
    """Find maximal unique exact matches between two code tensors."""
    rk, rvalid = kmer_codes(ref_codes, k)
    qk, qvalid = kmer_codes(query_codes, k)
    n_r, n_q = rk.shape[0], qk.shape[0]
    n = n_r + n_q

    codes = jnp.concatenate([rk, qk])
    invalid = jnp.concatenate([~rvalid, ~qvalid]).astype(jnp.int32)
    is_ref = jnp.concatenate(
        [jnp.ones(n_r, jnp.int32), jnp.zeros(n_q, jnp.int32)]
    )
    pos = jnp.concatenate(
        [jnp.arange(n_r, dtype=jnp.int32), jnp.arange(n_q, dtype=jnp.int32)]
    )

    # One big sort: (validity, code) keys; carry ownership + position.
    invalid, codes, is_ref, pos = lax.sort(
        (invalid, codes, is_ref, pos), num_keys=2
    )
    valid = invalid == 0

    idx = jnp.arange(n, dtype=jnp.int32)
    prev_code = jnp.roll(codes, 1)
    is_start = valid & ((codes != prev_code) | (idx == 0))

    # Segment bounds via prefix-max / suffix-min of start indices.
    seg_start = _prefix_max(jnp.where(is_start, idx, -1))
    nxt = jnp.where(is_start, idx, BIG)
    nxt_after = jnp.concatenate([_suffix_min(nxt)[1:], jnp.array([BIG])])
    seg_end = jnp.minimum(nxt_after - 1, n - 1)

    # Segment-level ref/query counts + the (single) ref position, via cumsums.
    ref_in = (is_ref == 1) & valid
    cum_ref = jnp.cumsum(ref_in.astype(jnp.int32))
    # int32 cumsum may wrap, but two's-complement differences recover any
    # segment sum that itself fits in int32 (single positions always do).
    cum_refpos = jnp.cumsum(jnp.where(ref_in, pos, 0).astype(jnp.int32))
    query_in = (is_ref == 0) & valid
    cum_query = jnp.cumsum(query_in.astype(jnp.int32))

    def seg_sum(cum, lo, hi):
        lo_v = jnp.where(lo > 0, cum[jnp.maximum(lo - 1, 0)], 0)
        return cum[hi] - lo_v

    ref_count = seg_sum(cum_ref, seg_start, seg_end)
    query_count = seg_sum(cum_query, seg_start, seg_end)
    ref_pos_sum = seg_sum(cum_refpos, seg_start, seg_end)

    is_match = valid & query_in & (ref_count == 1)
    if unique_in_query:
        is_match = is_match & (query_count == 1)

    rpos = ref_pos_sum.astype(jnp.int32)
    qpos = pos
    n_raw = jnp.sum(is_match.astype(jnp.int32))

    # Re-sort ALL matches by (diagonal, position) for run merging (runs are
    # merged over the full array; only merged runs are compacted, so dense
    # match sets — near-identical genomes — don't overflow).  On one
    # diagonal rpos and qpos advance together, so rpos ordering is qpos
    # ordering.
    diag = rpos - qpos
    sort_key = jnp.where(is_match, 0, 1).astype(jnp.int32)
    _, diag_c, rpos_c, qpos_c, match_s = lax.sort(
        (sort_key, diag, rpos, qpos, is_match.astype(jnp.int32)),
        num_keys=3,
    )
    m = max_seeds
    nc = n
    mask_c = match_s == 1
    cidx = jnp.arange(nc, dtype=jnp.int32)

    # Runs of consecutive k-mers on one diagonal.
    prev_mask = jnp.roll(mask_c, 1).at[0].set(False)
    run_start = mask_c & (
        ~prev_mask
        | (diag_c != jnp.roll(diag_c, 1))
        | (qpos_c != jnp.roll(qpos_c, 1) + 1)
    )
    next_continues = (
        jnp.roll(mask_c, -1)
        & (jnp.roll(diag_c, -1) == diag_c)
        & (jnp.roll(qpos_c, -1) == qpos_c + 1)
    )
    is_run_end = mask_c & ((cidx == nc - 1) | ~next_continues)
    run_start_idx = _prefix_max(jnp.where(run_start, cidx, -1))
    run_len_kmers = cidx - run_start_idx + 1
    run_rpos = rpos_c[jnp.maximum(run_start_idx, 0)]
    run_qpos = qpos_c[jnp.maximum(run_start_idx, 0)]

    n_runs = jnp.sum(is_run_end.astype(jnp.int32))

    # Final compaction to max_seeds entries, keeping (diag, qpos) order.
    out_key = jnp.where(is_run_end, 0, 1).astype(jnp.int32)
    _, o_rpos, o_qpos, o_len, o_mask = lax.sort(
        (
            out_key,
            run_rpos,
            run_qpos,
            run_len_kmers + (k - 1),
            is_run_end.astype(jnp.int32),
        ),
        num_keys=1,
        is_stable=True,
    )
    take = min(m, nc)
    out = SeedMatches(
        rpos=lax.dynamic_slice_in_dim(o_rpos, 0, take),
        qpos=lax.dynamic_slice_in_dim(o_qpos, 0, take),
        length=lax.dynamic_slice_in_dim(o_len, 0, take),
        mask=lax.dynamic_slice_in_dim(o_mask, 0, take) == 1,
        n_raw=n_raw,
        n_runs=n_runs,
    )
    return out


def auto_sample_shift(n_total: int) -> int:
    """Content-hash sampling policy: 1/4 density for joins >= 1M k-mers.

    The three O(n log^2 n) bitonic sorts dominate the fused seeding
    kernel; compacting to a hash-sampled subset BEFORE sort #1 cuts the
    sorted volume 4x (~3x kernel time) at bacterial scale.  Sampling is a
    pure function of k-mer CONTENT (FracMinHash-style), so a k-mer is
    kept in either both sequences or neither — the join and the
    uniqueness counts over sampled k-mers keep their exact semantics.
    Small inputs stay exact (and byte-stable for tests)."""
    return 2 if n_total >= (1 << 20) else 0


class SeedMatches2(NamedTuple):
    """Both-strand maximal matches: one sort-join for fwd + revcomp query."""

    rpos: jnp.ndarray
    qpos: jnp.ndarray  # strand-local (revcomp coordinates for reverse runs)
    length: jnp.ndarray
    reverse: jnp.ndarray  # bool [M] strand of each run
    mask: jnp.ndarray
    n_raw: jnp.ndarray
    n_runs: jnp.ndarray
    samp_over: jnp.ndarray  # int32 [] 1 = sample buffer overflowed (redo unsampled)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_seeds", "unique_in_query", "sample_shift", "merge_gap",
    ),
)
def find_seeds_both(
    ref_codes,
    query_codes,
    q_len,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    sample_shift: int = 0,
    merge_gap: int | None = None,
) -> SeedMatches2:
    """Both-strand variant of `find_seeds` via one canonical-k-mer join.

    Each window contributes its canonical code min(fwd, revcomp) plus a
    strand bit, so ONE sorted array of n_ref + n_query elements covers
    both orientations (a forward match has equal strand bits, a reverse
    match opposite bits) — a third less sort traffic than separate
    fwd + revcomp query streams, and no revcomp stream materialized at
    all.  For k <= 15 the canonical code fits 30 bits and sort #1 runs
    with a single packed 32-bit key.

    Gather-free segment reductions: segment-boundary values of the
    (nondecreasing) count cumsums are extracted with prefix-max /
    suffix-min instead of indexed gathers; run start coordinates follow
    arithmetically from run lengths.  Sort keys for the re-sort and the
    compaction are bit-packed (flag | owner | 24-bit value), which bounds
    per-sequence bucket sizes to 2^23 — far above bacterial genomes; long
    eukaryotic contigs should be windowed by the caller.

    Uniqueness is canonical: a k-mer whose reverse complement also occurs
    in the reference is not ref-unique (nucmer counts forward text only;
    the canonical rule is conservative at inverted repeats, which unique-
    match seeding should not anchor anyway).

    With ``sample_shift`` > 0 (k <= 15 only), k-mers are content-hash
    sampled at density 2^-shift and compacted BEFORE sort #1 — the sorts
    run on the compacted buffer, ~2^shift times smaller.  Sampling is a
    pure function of the canonical code, so every occurrence of a k-mer
    is kept or dropped together: the join and the uniqueness counts keep
    exact semantics over the sampled universe.  Runs then merge along a
    diagonal across gaps <= 3 * 2^shift (sampled anchors are ~2^shift
    apart), recovering MUM-scale spans; `samp_over` reports a (rare,
    composition-adversarial) sample-buffer overflow so callers can redo
    unsampled.
    """
    from paramugsy_tpu.ops.encode import kmer_canonical

    rk, rstrand, rvalid = kmer_canonical(ref_codes, k)
    qk, qstrand, qvalid = kmer_canonical(query_codes, k)
    n_r, n_q = rk.shape[0], qk.shape[0]
    n = n_r + n_q
    if max(n_r, n_q) >= 1 << 23:
        raise ValueError("sequence bucket exceeds 2^23; window the input")
    if k > 15:
        sample_shift = 0
    if merge_gap is None:
        # Wide default under sampling: same-diagonal anchors merge across
        # SNP breaks (the flanks pin the diagonal; substitution columns
        # render correctly from the sequence text), collapsing run counts
        # ~200x on 1%-diverged pairs — the d2h payload and the host tail
        # shrink with them.
        merge_gap = 16 << sample_shift if sample_shift else 0

    # owner|strand|pos packed into one int32 (1 + 1 + 23 bits).
    M23 = (1 << 23) - 1
    packed = jnp.concatenate(
        [
            (rstrand.astype(jnp.int32) << 23) | jnp.arange(n_r, dtype=jnp.int32),
            (1 << 24)
            | (qstrand.astype(jnp.int32) << 23)
            | jnp.arange(n_q, dtype=jnp.int32),
        ]
    )
    invalid_b = jnp.concatenate([~rvalid, ~qvalid])
    samp_over = jnp.int32(0)

    if k <= 15:
        # Sort #1: single u32 key [dropped/invalid(1)][canon(30)][owner(1)],
        # one payload.  The OWNER bit in the key makes every segment's ref
        # entries sort before its query entries, which turns all segment
        # lookups below into forward carries — no suffix scan, no gathers.
        canon_all = jnp.concatenate([rk, qk])
        owner_key = jnp.concatenate(
            [jnp.zeros(n_r, jnp.uint32), jnp.ones(n_q, jnp.uint32)]
        )
        codes_all = (canon_all << jnp.uint32(1)) | owner_key
        key1 = codes_all | (invalid_b.astype(jnp.uint32) << jnp.uint32(31))
        if sample_shift:
            h = canon_all * jnp.uint32(2654435761)
            keep = (h >> jnp.uint32(32 - sample_shift)) == 0
            keep = keep & ~invalid_b
            # Static compacted size: mean density + 12.5% headroom (the
            # hash is content-uniform, so the sampled count's spread is
            # binomial — ~1k at bacterial scale vs ~130k headroom; a
            # composition-adversarial overflow still lands in samp_over
            # and redoes exact).
            B = ((n >> sample_shift) + (n >> (sample_shift + 3)) + 1023) & ~1023
            B = min(B, n)
            n_samp = jnp.sum(keep.astype(jnp.int32))
            samp_over = (n_samp > B).astype(jnp.int32)
            # Compact first, then sort the 2^shift-smaller buffer.
            pos_c = jnp.cumsum(keep.astype(jnp.int32)) - 1
            dst = jnp.where(keep, pos_c, B)  # out of range -> dropped
            key1 = (
                jnp.full((B,), jnp.uint32(1 << 31))
                .at[dst]
                .set(key1, mode="drop")
            )
            packed = jnp.zeros((B,), jnp.int32).at[dst].set(
                packed, mode="drop"
            )
            key1, packed = lax.sort((key1, packed), num_keys=1)
            n = B
        else:
            key1, packed = lax.sort((key1, packed), num_keys=1)
        valid = key1 < jnp.uint32(1 << 31)
        seg_key = key1 >> jnp.uint32(1)  # owner stripped: the segment id
        same_code = seg_key == jnp.roll(seg_key, 1)
    else:
        codes = jnp.concatenate([rk, qk])
        invalid = invalid_b.astype(jnp.uint8)
        # packed is the 3rd sort key: its owner bit (24) sits above the
        # 23-bit position, so refs sort first within each segment here too.
        invalid, codes, packed = lax.sort((invalid, codes, packed), num_keys=3)
        valid = invalid == 0
        same_code = codes == jnp.roll(codes, 1)

    owner = packed >> jnp.int32(24)
    strand = (packed >> jnp.int32(23)) & 1
    pos = packed & M23

    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = valid & (~same_code | (idx == 0))
    ref_in = (owner == 0) & valid
    query_in = (owner > 0) & valid

    # Refs sort first within a segment, so the segment has a UNIQUE ref
    # iff its first element is a ref and its second is not.  One forward
    # carry hands (first element's packed, two-refs flag) to every
    # element — no cumsum, suffix scan or gather.
    nxt_ref = jnp.concatenate([ref_in[1:], jnp.array([False])])
    nxt_same = jnp.concatenate([same_code[1:], jnp.array([False])])
    two_refs = is_start & ref_in & nxt_same & nxt_ref
    seen, first_info = _carry_last_marked(
        is_start, packed | (two_refs.astype(jnp.int32) << 25)
    )
    first_packed = first_info & ((1 << 25) - 1)
    one_ref = ((first_packed >> jnp.int32(24)) == 0) & (
        ((first_info >> jnp.int32(25)) & 1) == 0
    )
    rpos = first_packed & M23
    r_strand = (first_packed >> jnp.int32(23)) & 1

    is_match = valid & query_in & seen & one_ref
    if unique_in_query:
        # Canonical query-uniqueness (--mum: a k-mer repeated across
        # strands is not query-unique) needs the segment's TOTAL query
        # count — suffix information; keep the two-sided formulation for
        # this (non-default) mode.
        nxt_invalid = jnp.concatenate([~valid[1:], jnp.array([True])])
        nxt_start = jnp.concatenate([is_start[1:], jnp.array([True])])
        is_end = valid & (nxt_start | nxt_invalid)
        cum_query = jnp.cumsum(query_in.astype(jnp.int32))
        before = _prefix_max(
            jnp.where(is_start, cum_query - query_in.astype(jnp.int32), -1)
        )
        at_end = _suffix_min(jnp.where(is_end, cum_query, BIG))
        is_match = is_match & ((at_end - before) == 1)

    n_raw = jnp.sum(is_match.astype(jnp.int32))

    # Strand-local query position: reverse matches (opposite strand bits)
    # anchor in revcomp coordinates, where consecutive window pairs again
    # advance both positions by +1.
    rev = strand != r_strand
    qpos_local = jnp.where(rev, q_len - pos - k, pos)
    owner2 = 1 + rev.astype(jnp.int32)  # 1 = forward, 2 = reverse

    # Sort #2: packed key (match flag | owner | diag+offset) then rpos.
    # Within one diagonal rpos order IS qpos order, so qpos is derived
    # arithmetically instead of carried as a third operand.
    OFF = 1 << 23
    diag = rpos - qpos_local + OFF  # in [0, 2^24)
    # Non-matches collapse to the sentinel: their diag/owner fields hold
    # garbage (segments without a ref) that must not leak into key bits.
    key2 = jnp.where(
        is_match, (owner2 << jnp.int32(24)) | diag, jnp.int32(1 << 30)
    ).astype(jnp.int32)
    key2, rpos_c = lax.sort((key2, rpos), num_keys=2)
    if sample_shift and k <= 15:
        # Matches sort to the front (non-matches carry the sentinel), so
        # the run-merge + sort #3 stages can run on a static slice: the
        # match count is structurally <= the sampled query k-mers
        # (~n_q/n of the buffer), so 5/8 covers the equal-length case
        # with margin; an asymmetric-pair overflow sets a samp_over bit
        # and the caller redoes the pair exact.
        B2 = min(n, ((n * 5 // 8) + 1023) & ~1023)
        samp_over = samp_over | (jnp.int32(2) * (n_raw > B2).astype(jnp.int32))
        key2 = lax.slice_in_dim(key2, 0, B2)
        rpos_c = lax.slice_in_dim(rpos_c, 0, B2)
        n = B2
    mask_c = key2 < (1 << 30)
    owner_c = (key2 >> jnp.int32(24)) & 3
    qpos_c = rpos_c - (key2 & (OFF * 2 - 1)) + OFF  # garbage when masked
    cidx = jnp.arange(n, dtype=jnp.int32)

    prev_mask = jnp.roll(mask_c, 1).at[0].set(False)
    # Same-diagonal runs merge across ref steps of 1..merge_gap+1 (step 1
    # = consecutive k-mers, the exact-join case; larger steps only under
    # sampling, where kept anchors are ~2^shift apart).
    dr_prev = rpos_c - jnp.roll(rpos_c, 1)
    run_start = mask_c & (
        ~prev_mask
        | (key2 != jnp.roll(key2, 1))  # owner or diag change
        | (dr_prev < 1)
        | (dr_prev > merge_gap + 1)
    )
    dr_next = jnp.roll(rpos_c, -1) - rpos_c
    next_continues = (
        jnp.roll(mask_c, -1)
        & (jnp.roll(key2, -1) == key2)
        & (dr_next >= 1)
        & (dr_next <= merge_gap + 1)
    )
    is_run_end = mask_c & ((cidx == n - 1) | ~next_continues)
    # Run span from the start anchor's coordinates, carried forward
    # gather-free.
    _, rpos0 = _carry_last_marked(run_start, rpos_c)
    run_rpos = rpos0
    run_qpos = qpos_c - (rpos_c - rpos0)
    run_span = rpos_c - rpos0 + k

    n_runs = jnp.sum(is_run_end.astype(jnp.int32))

    # Sort #3 (compaction): packed key (runend flag | owner | run_rpos).
    key3 = jnp.where(
        is_run_end, (owner_c << jnp.int32(24)) | run_rpos, jnp.int32(1 << 30)
    ).astype(jnp.int32)
    key3, o_qpos, o_len = lax.sort(
        (key3, run_qpos, run_span), num_keys=1, is_stable=True
    )
    take = min(max_seeds, n)
    cut = lambda x: lax.dynamic_slice_in_dim(x, 0, take)  # noqa: E731
    key3_c = cut(key3)
    return SeedMatches2(
        rpos=key3_c & (OFF * 2 - 1),
        qpos=cut(o_qpos),
        length=cut(o_len),
        reverse=((key3_c >> jnp.int32(24)) & 3) == 2,
        mask=key3_c < (1 << 30),
        n_raw=n_raw,
        n_runs=n_runs,
       samp_over=samp_over,
    )


def revcomp_on_device(codes, n):
    """Reverse-complement of the first ``n`` codes of a padded tensor.

    Complement (N stays N), reverse, then roll the trailing padding back
    to the end so strand-local coordinates stay 0-based at the sequence
    start.  ``n`` may be a traced scalar: the roll amount is dynamic, the
    shape is not.
    """
    rc = jnp.where(codes >= 4, codes, 3 - codes)[::-1]
    return jnp.roll(rc, n - codes.shape[0])


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_seeds", "unique_in_query", "min_match",
        "band", "max_gap", "max_clusters", "sample_shift", "merge_gap",
        "m_out", "c_out",
    ),
)
def seed_cluster_both_packed(
    ref_codes,
    query_codes,
    query_rc_codes=None,
    q_len=None,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
    sample_shift: int = 0,
    merge_gap: int | None = None,
    m_out: int | None = None,
    c_out: int | None = None,
):
    """Seeding + both-strand clustering fused into one dispatch, with every
    output packed into ONE int32 vector.

    One device->host transfer per pair, and a small one: ``m_out``/``c_out`` slice the transferred seed/cluster
    buckets below the compute buckets (valid seeds sort to the front of
    each strand's arrays, valid clusters to the front of the summaries,
    so a prefix is lossless as long as it is big enough; per-strand
    ``n_valid``/``n_clusters`` counts let the caller DETECT truncation
    and refetch full-size — under sampled seeding the measured ~250
    merged runs per bacterial pair sit far below the 4096 compute
    bucket, so the slice cuts the d2h payload ~4x).  Layout (all int32),
    with M = m_out or the compute bucket, C = c_out or max_clusters:

        [M, C, m_compute, n_raw, n_runs, samp_over]
        then per strand (forward, reverse):
          seed_rpos[M], seed_qpos[M], seed_len[M],
          c_first[C], c_rstart[C], c_rend[C], c_qstart[C], c_qend[C],
          c_weight[C], c_nseeds[C], c_mask[C], n_clusters[1], n_valid[1]

    (Per-seed cluster ids are NOT transferred: clusters are contiguous
    runs of the sorted seed order, so c_first + c_nseeds recover the
    membership — 25% less d2h per pair.)

    Unpack on host with `unpack_seed_clusters`.  ``samp_over`` = 1 means
    the content-hash sample buffer overflowed (redo with sample_shift=0).
    """
    from paramugsy_tpu.ops.chaining import cluster_seeds

    del query_rc_codes  # canonical join needs no revcomp stream
    seeds = find_seeds_both(
        ref_codes, query_codes, q_len,
        k=k, max_seeds=max_seeds, unique_in_query=unique_in_query,
        sample_shift=sample_shift, merge_gap=merge_gap,
    )
    base_keep = seeds.mask & (seeds.length >= min_match)
    # Effective sizes (static): find_seeds/cluster outputs shrink to the
    # input size for small buckets.
    m_eff = seeds.rpos.shape[0]
    c_eff = min(max_clusters, m_eff)
    m_o = m_eff if m_out is None else min(m_out, m_eff)
    c_o = c_eff if c_out is None else min(c_out, c_eff)
    parts = [
        jnp.array([m_o, c_o, m_eff], jnp.int32),
        seeds.n_raw[None],
        seeds.n_runs[None],
        seeds.samp_over[None],
    ]
    for reverse in (False, True):
        keep = base_keep & (seeds.reverse == reverse)
        n_valid = jnp.sum(keep.astype(jnp.int32))
        cl = cluster_seeds(
            seeds.rpos, seeds.qpos, seeds.length, keep,
            band=band, max_gap=max_gap, max_clusters=max_clusters,
        )
        cm = lambda x: lax.slice_in_dim(x, 0, m_o)  # noqa: E731
        cc = lambda x: lax.slice_in_dim(x, 0, c_o)  # noqa: E731
        parts.extend(
            [
                cm(cl.seed_rpos), cm(cl.seed_qpos), cm(cl.seed_len),
                cc(cl.c_first), cc(cl.c_rstart), cc(cl.c_rend),
                cc(cl.c_qstart), cc(cl.c_qend),
                cc(cl.c_weight), cc(cl.c_nseeds),
                cc(cl.c_mask.astype(jnp.int32)),
                cl.n_clusters[None],
                n_valid[None],
            ]
        )
    return jnp.concatenate(parts)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_seeds", "unique_in_query", "min_match",
        "band", "max_gap", "max_clusters", "sample_shift", "merge_gap",
        "m_out", "c_out",
    ),
)
def seed_cluster_both_packed_batch(
    ref_codes,
    query_codes,
    q_len,
    *,
    k: int = 15,
    max_seeds: int = 1 << 16,
    unique_in_query: bool = False,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
    sample_shift: int = 0,
    merge_gap: int | None = None,
    m_out: int | None = None,
    c_out: int | None = None,
):
    """Batched `seed_cluster_both_packed`: a CHUNK of pairs per dispatch.

    ref_codes/query_codes: [B, N_r]/[B, N_q] padded code batches (same
    bucket per launch), q_len: [B].  Returns packed int32 [B, L] — one
    device dispatch and one device->host transfer for the whole chunk
    (the reference chunked its nucmer fan-out for the same reason:
    lib/base/job_processor.ml:128-154).  The same function, shard_mapped
    over a `pairs` mesh axis, is the multi-chip data path
    (parallel/pair_shard.py).
    """

    def one(r, q, ql):
        return seed_cluster_both_packed(
            r, q, None, ql,
            k=k, max_seeds=max_seeds, unique_in_query=unique_in_query,
            min_match=min_match, band=band, max_gap=max_gap,
            max_clusters=max_clusters, sample_shift=sample_shift,
            merge_gap=merge_gap, m_out=m_out, c_out=c_out,
        )

    return jax.vmap(one)(ref_codes, query_codes, q_len)


@functools.partial(jax.jit, static_argnames=("k", "max_seeds"))
def find_repeat_seeds(
    ref_codes,
    ref_rc_codes,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
) -> SeedMatches2:
    """Self-repeat seeding (the ``nucmer`` genome-vs-self role that feeds
    Mugsy's duplication detection, cf. mugsy_mugsy -dup_list /
    mugsyWGA --duplications: lib/mugsy/mugsy_mugsy.ml:125-144).

    Unique-match seeding cannot see repeats by construction (a duplicated
    k-mer is never ref-unique), and enumerating all occurrence pairs is a
    data-dependent cross product.  Instead we pair **adjacent occurrences**
    in the k-mer sort: after sorting (code, owner|pos) over the forward +
    revcomp streams, element i-1 with the same code is the previous
    occurrence, so each repeated k-mer yields the chain of consecutive-copy
    pairs (c1,c2), (c2,c3), ... — the same representation MUMmer's
    ``repeat-match`` reports.  Pair types:

    * fwd->fwd: direct repeat, copy1 pos < copy2 pos by sort order;
    * fwd->rc : inverted repeat (copy2 in revcomp-local coordinates);
    * rc->rc and rc->fwd pairs are mirrors of the above and are dropped.

    Consecutive k-mers of one repeat advance both positions by 1 on a
    constant diagonal, so the run-merge machinery is identical to
    `find_seeds_both`; `reverse` in the output marks inverted pairs.
    """
    rk, rvalid = kmer_codes(ref_codes, k)
    ck, cvalid = kmer_codes(ref_rc_codes, k)
    n_f, n_c = rk.shape[0], ck.shape[0]
    n = n_f + n_c
    if max(n_f, n_c) >= 1 << 23:
        raise ValueError("sequence bucket exceeds 2^23; window the input")

    codes = jnp.concatenate([rk, ck])
    invalid = jnp.concatenate([~rvalid, ~cvalid]).astype(jnp.uint8)
    packed = jnp.concatenate(
        [
            jnp.arange(n_f, dtype=jnp.int32),
            (1 << 23) | jnp.arange(n_c, dtype=jnp.int32),
        ]
    )
    invalid, codes, packed = lax.sort((invalid, codes, packed), num_keys=3)
    valid = invalid == 0
    owner = packed >> jnp.int32(23)
    pos = packed & ((1 << 23) - 1)

    idx = jnp.arange(n, dtype=jnp.int32)
    prev_owner = jnp.roll(owner, 1)
    p1 = jnp.roll(pos, 1)
    same = (
        valid
        & jnp.roll(valid, 1)
        & (codes == jnp.roll(codes, 1))
        & (idx > 0)
        & (prev_owner == 0)  # copy1 always in forward coordinates
    )
    is_match = same  # owner==0: direct pair; owner==1: inverted pair
    n_raw = jnp.sum(is_match.astype(jnp.int32))

    # Run merging: identical to find_seeds_both sort #2/#3 with
    # rpos := copy1 (fwd), qpos := copy2 (strand-local of `owner`).
    OFF = 1 << 23
    diag = p1 - pos + OFF
    key2 = jnp.where(
        is_match, (owner << jnp.int32(24)) | diag, jnp.int32(1 << 30)
    ).astype(jnp.int32)
    key2, rpos_c, qpos_c = lax.sort((key2, p1, pos), num_keys=2)
    mask_c = key2 < (1 << 30)
    owner_c = (key2 >> jnp.int32(24)) & 3

    next_continues = (
        jnp.roll(mask_c, -1)
        & (jnp.roll(key2, -1) == key2)
        & (jnp.roll(qpos_c, -1) == qpos_c + 1)
    )
    prev_mask = jnp.roll(mask_c, 1).at[0].set(False)
    run_start = mask_c & (
        ~prev_mask
        | (key2 != jnp.roll(key2, 1))
        | (qpos_c != jnp.roll(qpos_c, 1) + 1)
    )
    is_run_end = mask_c & ((idx == n - 1) | ~next_continues)
    run_start_idx = _prefix_max(jnp.where(run_start, idx, -1))
    run_len_kmers = idx - run_start_idx + 1
    run_rpos = rpos_c - run_len_kmers + 1
    run_qpos = qpos_c - run_len_kmers + 1
    n_runs = jnp.sum(is_run_end.astype(jnp.int32))

    key3 = jnp.where(
        is_run_end, (owner_c << jnp.int32(24)) | run_rpos, jnp.int32(1 << 30)
    ).astype(jnp.int32)
    key3, o_qpos, o_len = lax.sort(
        (key3, run_qpos, run_len_kmers + (k - 1)), num_keys=1, is_stable=True
    )
    take = min(max_seeds, n)
    cut = lambda x: lax.dynamic_slice_in_dim(x, 0, take)  # noqa: E731
    key3_c = cut(key3)
    return SeedMatches2(
        rpos=key3_c & (OFF * 2 - 1),
        qpos=cut(o_qpos),
        length=cut(o_len),
        reverse=((key3_c >> jnp.int32(24)) & 3) == 1,
        mask=key3_c < (1 << 30),
        n_raw=n_raw,
        n_runs=n_runs,
       samp_over=jnp.int32(0),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "max_seeds", "min_match", "band", "max_gap", "max_clusters",
    ),
)
def repeat_cluster_packed(
    ref_codes,
    ref_rc_codes=None,
    r_len=None,
    *,
    k: int = 16,
    max_seeds: int = 1 << 16,
    min_match: int = 20,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
):
    """Fused self-repeat seeding + per-type clustering, packed like
    `seed_cluster_both_packed` (strand slot 0 = direct, 1 = inverted);
    unpack on host with `unpack_seed_clusters`."""
    from paramugsy_tpu.ops.chaining import cluster_seeds

    if ref_rc_codes is None:
        ref_rc_codes = revcomp_on_device(ref_codes, r_len)
    seeds = find_repeat_seeds(
        ref_codes, ref_rc_codes, k=k, max_seeds=max_seeds
    )
    base_keep = seeds.mask & (seeds.length >= min_match)
    m_eff = seeds.rpos.shape[0]
    c_eff = min(max_clusters, m_eff)
    parts = [
        jnp.array([m_eff, c_eff, m_eff], jnp.int32),
        seeds.n_raw[None],
        seeds.n_runs[None],
        seeds.samp_over[None],
    ]
    for inverted in (False, True):
        keep = base_keep & (seeds.reverse == inverted)
        n_valid = jnp.sum(keep.astype(jnp.int32))
        cl = cluster_seeds(
            seeds.rpos, seeds.qpos, seeds.length, keep,
            band=band, max_gap=max_gap, max_clusters=max_clusters,
        )
        parts.extend(
            [
                cl.seed_rpos, cl.seed_qpos, cl.seed_len,
                cl.c_first, cl.c_rstart, cl.c_rend, cl.c_qstart, cl.c_qend,
                cl.c_weight, cl.c_nseeds, cl.c_mask.astype(jnp.int32),
                cl.n_clusters[None],
                n_valid[None],
            ]
        )
    return jnp.concatenate(parts)


class HostClusters(NamedTuple):
    """Host-side unpacked per-strand clustering results (NumPy arrays)."""

    seed_rpos: "object"
    seed_qpos: "object"
    seed_len: "object"
    c_first: "object"
    c_rstart: "object"
    c_rend: "object"
    c_qstart: "object"
    c_qend: "object"
    c_weight: "object"
    c_nseeds: "object"
    c_mask: "object"
    n_clusters: int
    n_valid: int  # valid (min_match-filtered) seeds of this strand

    @property
    def truncated(self) -> bool:
        """Did the m_out/c_out output slice cut off valid data?  If so
        the caller must refetch with full-size output buckets."""
        return (
            self.n_valid > len(self.seed_rpos)
            or self.n_clusters > len(self.c_first)
        )


def unpack_seed_clusters(packed, max_seeds: int, max_clusters: int):
    """Split `seed_cluster_both_packed` output:
    (n_raw, n_runs, samp_over, m_compute, [fwd, rev]).

    ``n_runs > m_compute`` means the COMPUTE bucket overflowed (retry
    with a bigger ``max_seeds``); ``strand.truncated`` means only the
    m_out/c_out output slice was too small (refetch with full-size
    output, same compute bucket)."""
    import numpy as np

    buf = np.asarray(packed)
    M, C, m_compute = int(buf[0]), int(buf[1]), int(buf[2])
    assert M <= max_seeds and C <= max_clusters
    n_raw, n_runs, samp_over = int(buf[3]), int(buf[4]), int(buf[5])
    off = 6
    strands = []
    for _ in range(2):
        fields = []
        for size in (M, M, M, C, C, C, C, C, C, C, C):
            fields.append(buf[off : off + size])
            off += size
        n_clusters = int(buf[off])
        n_valid = int(buf[off + 1])
        off += 2
        fields[10] = fields[10] != 0  # c_mask back to bool
        strands.append(HostClusters(*fields, n_clusters, n_valid))
    return n_raw, n_runs, samp_over, m_compute, strands
