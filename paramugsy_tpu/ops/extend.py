"""Inter-anchor gap alignment (the nucmer extension role).

Global (Needleman-Wunsch) alignment of the short ref/query segments between
chained anchors, batched over all segments of all chains.  Scores use the
cummax formulation: within a row,

    dp[j] = GAP*j + running_max(cand[k] - GAP*k)  for k <= j

which turns the row's sequential left-gap dependency into a prefix scan.

This module holds the NumPy reference implementations and the host
tracebacks, and routes segments to the engines: the native C++ full DP for
short segments, and for long ones the device wavefront
(`paramugsy_tpu.ops.wavefront`) on an accelerator or the C++ banded engine
on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from paramugsy_tpu.coords.range import Range

NEG = np.int32(-(10**8))

DIAG, UP, LEFT = 0, 1, 2  # UP consumes ref (gap in query), LEFT consumes query


@dataclass
class Scoring:
    match: int = 2
    mismatch: int = -3
    gap: int = -4


def nw_align_batch(
    a: np.ndarray, a_len: np.ndarray, b: np.ndarray, b_len: np.ndarray,
    scoring: Scoring = Scoring(),
):
    """Batched global alignment.

    a, b: [B, S] int8 code arrays (ref, query segments), padded.
    Returns (dirs [B, S+1, S+1] uint8, score [B]).
    """
    B, S = a.shape
    GAP = scoring.gap
    dp_prev = np.tile((np.arange(S + 1) * GAP).astype(np.int32), (B, 1))
    dirs = np.zeros((B, S + 1, S + 1), dtype=np.uint8)
    dirs[:, 0, 1:] = LEFT
    j_idx = np.arange(S + 1, dtype=np.int32)
    gap_j = (GAP * j_idx).astype(np.int32)

    for i in range(1, S + 1):
        sub = np.where(a[:, i - 1 : i] == b, scoring.match, scoring.mismatch)
        # mask out padded query columns (j-1 >= b_len) handled by final readout
        diag = dp_prev[:, :-1] + sub  # j = 1..S
        up = dp_prev[:, 1:] + GAP
        cand = np.maximum(diag, up)
        u = np.empty((B, S + 1), dtype=np.int32)
        u[:, 0] = np.int32(GAP * i)
        u[:, 1:] = cand - gap_j[1:]
        run = np.maximum.accumulate(u, axis=1)
        dp_cur = run + gap_j
        d = np.full((B, S + 1), LEFT, dtype=np.uint8)
        d[:, 0] = UP
        is_up = dp_cur[:, 1:] == up
        is_diag = dp_cur[:, 1:] == diag
        d[:, 1:][is_up] = UP
        d[:, 1:][is_diag] = DIAG  # prefer diag on ties
        dirs[:, i] = d
        dp_prev = dp_cur

    score = dp_prev[np.arange(B), b_len]  # only valid when a_len == S; fix below
    return dirs, score


def traceback_gaps(dirs_i: np.ndarray, a_len: int, b_len: int):
    """Walk one direction matrix back from (a_len, b_len).

    Returns (ref_gap_runs, query_gap_runs, n_columns): 1-indexed runs in
    alignment-column space, plus total columns.
    """
    return _walk(a_len, b_len, lambda i, j: dirs_i[i, j])


def _runs_of_cols(cols: list[int]):
    """Walk-order column kinds (0 = match, 1 = ref gap, 2 = query gap) ->
    (ref_gap_runs, query_gap_runs, n_columns), runs 1-indexed in
    alignment-column space."""
    cols.reverse()
    n = len(cols)
    ref_runs: list[Range] = []
    query_runs: list[Range] = []
    start = None
    kind = 0
    for idx, c in enumerate(cols + [0]):
        if c != kind:
            if kind == 1:
                ref_runs.append(Range(start + 1, idx))
            elif kind == 2:
                query_runs.append(Range(start + 1, idx))
            if c != 0:
                start = idx
            kind = c
    return ref_runs, query_runs, n


def _walk(a_len: int, b_len: int, code_at):
    """Traceback from (a_len, b_len); ``code_at(i, j)`` gives the direction
    of an interior cell.  Returns the runs of `_runs_of_cols`."""
    i, j = a_len, b_len
    cols: list[int] = []
    while i > 0 or j > 0:
        if i == 0:
            d = LEFT
        elif j == 0:
            d = UP
        else:
            d = code_at(i, j)
        if d == DIAG:
            cols.append(0)
            i -= 1
            j -= 1
        elif d == UP:
            cols.append(2)
            i -= 1
        else:
            cols.append(1)
            j -= 1
    return _runs_of_cols(cols)


def traceback_band(dirs: np.ndarray, a_len: int, b_len: int, width: int):
    """Traceback over banded direction rows ``dirs[i - 1, w]``, lane
    w = j - i + width/2 (the layout of `banded_align_np`)."""
    half = width // 2

    def code_at(i, j):
        w = j - i + half
        if w < 0:
            return UP
        if w >= width:
            return LEFT
        return int(dirs[i - 1, w])

    return _walk(a_len, b_len, code_at)


def traceback_wavefront(dirs_packed: np.ndarray, a_len: int, b_len: int, width: int):
    """Traceback over packed anti-diagonal directions of ONE pair
    ([steps/16, width] int32; step d's code is
    ``(dirs_packed[(d-1)//16, w] >> (2*((d-1)%16))) & 3``), the layout of
    `wavefront.wavefront_dirs`."""
    half = width // 2

    def code_at(i, j):
        w = j - i + half
        if w <= 0:
            return UP
        if w >= width - 1:
            return LEFT
        s = i + j - 1
        return (int(dirs_packed[s >> 4, w]) >> (2 * (s & 15))) & 3

    return _walk(a_len, b_len, code_at)


def align_segments(
    segs: list[tuple[np.ndarray, np.ndarray]], scoring: Scoring = Scoring()
):
    """Align a list of (ref_codes, query_codes) segment pairs.

    Returns per segment (ref_gap_runs, query_gap_runs, n_columns).  Segments
    are bucketed by max length to keep padding waste bounded.
    """
    results: list = [None] * len(segs)
    if not segs:
        return results
    la = np.fromiter((len(s[0]) for s in segs), dtype=np.int64, count=len(segs))
    lb = np.fromiter((len(s[1]) for s in segs), dtype=np.int64, count=len(segs))
    # Degenerate / trivial cases need no DP: one side empty, or 1-vs-1
    # when a single substitution beats two gaps (mismatch >= 2*gap; the
    # DP's DIAG tie preference makes >= the exact condition).
    one_v_one_ok = scoring.mismatch >= 2 * scoring.gap
    trivial = (la == 0) | (lb == 0)
    if one_v_one_ok:
        trivial |= (la == 1) & (lb == 1)
    for i in np.flatnonzero(trivial):
        a_n, b_n = int(la[i]), int(lb[i])
        if a_n == 0 and b_n == 0:
            results[i] = ([], [], 0)
        elif a_n == 0:
            results[i] = ([Range(1, b_n)], [], b_n)
        elif b_n == 0:
            results[i] = ([], [Range(1, a_n)], a_n)
        else:
            results[i] = ([], [], 1)
    batch = np.flatnonzero(np.array([r is None for r in results], dtype=bool))
    lmax = np.maximum(la, lb)
    # Bucketed batches with vectorized padding (one boolean scatter per
    # side instead of a Python loop over segments).
    BUCKETS = (16, 64, 256, 1024, 4096)
    lane = {bk: np.arange(bk) for bk in BUCKETS}
    for bucket in BUCKETS:
        idxs = batch[lmax[batch] <= bucket]
        batch = batch[lmax[batch] > bucket]
        if len(idxs) == 0:
            continue
        B = len(idxs)
        a_len = la[idxs].astype(np.int32)
        b_len = lb[idxs].astype(np.int32)
        a = np.full((B, bucket), 4, dtype=np.int8)
        b = np.full((B, bucket), 4, dtype=np.int8)
        a[lane[bucket][None, :] < a_len[:, None]] = np.concatenate(
            [segs[i][0] for i in idxs]
        )
        b[lane[bucket][None, :] < b_len[:, None]] = np.concatenate(
            [segs[i][1] for i in idxs]
        )
        from paramugsy_tpu.ops import engines
        from paramugsy_tpu.ops.native import nw_align_batch_native

        nat = nw_align_batch_native(
            a, a_len, b, b_len, scoring.match, scoring.mismatch, scoring.gap
        )
        if nat is not None:
            engines.record("native-nw", B)
            cols, nruns, runs = nat
            for bi, i in enumerate(idxs):
                rr = runs[bi, : nruns[bi]]
                ref_runs = [Range(int(s), int(e)) for side, s, e in rr if side == 0]
                query_runs = [Range(int(s), int(e)) for side, s, e in rr if side == 1]
                results[i] = (ref_runs, query_runs, int(cols[bi]))
        else:
            engines.record("numpy-nw", B)
            dirs, _ = nw_align_batch(a, a_len, b, b_len, scoring)
            for bi, i in enumerate(idxs):
                results[i] = traceback_gaps(dirs[bi], int(a_len[bi]), int(b_len[bi]))
    # Long segments route to the banded engines: the batched device
    # wavefront on an accelerator, the host C++/NumPy engine on the CPU.
    long_idx = [i for i, r in enumerate(results) if r is None]
    if long_idx:
        from paramugsy_tpu.ops import engines

        long_segs = [
            (np.asarray(segs[i][0]), np.asarray(segs[i][1])) for i in long_idx
        ]
        if engines.device_dp_enabled():
            from paramugsy_tpu.ops.wavefront import wavefront_align_many

            outs = wavefront_align_many(
                long_segs,
                match=scoring.match,
                mismatch=scoring.mismatch,
                gap=scoring.gap,
            )
            engines.record("device-wavefront", len(long_segs))
        else:
            outs = [align_long_segment(a, b, scoring) for a, b in long_segs]
        for i, o in zip(long_idx, outs):
            results[i] = o
    return results


def align_segments_spans(
    ref_np: np.ndarray,
    qry_np: np.ndarray,
    r0: np.ndarray,
    r1: np.ndarray,
    q0: np.ndarray,
    q1: np.ndarray,
    scoring: Scoring = Scoring(),
):
    """Batched inter-anchor alignment from span arrays (0-based half-open).

    Semantically identical to ``align_segments`` over the corresponding
    slices, but the segments never exist as Python objects: the native
    kernel reads straight from the full genome arrays, and only segments
    that actually produced gaps surface as Range lists.  (Slicing and
    re-marshalling ~20k tiny views per pair dominated the host tail.)

    Returns (ncols [n] int64, gapped: dict seg_idx -> (ref_runs, q_runs)).
    """
    n = len(r0)
    if n == 0:
        return np.zeros(0, np.int64), {}
    from paramugsy_tpu.ops import engines
    from paramugsy_tpu.ops.native import nw_segments_native

    nat = nw_segments_native(
        ref_np, qry_np, r0, r1, q0, q1,
        scoring.match, scoring.mismatch, scoring.gap,
    )
    if nat is None:  # no native library: slice + the generic path
        res = align_segments(
            [(ref_np[a:b], qry_np[c:d]) for a, b, c, d in zip(r0, r1, q0, q1)],
            scoring,
        )
        ncols = np.fromiter((r[2] for r in res), np.int64, count=n)
        gapped = {t: (rg, qg) for t, (rg, qg, _) in enumerate(res) if rg or qg}
        return ncols, gapped
    cols, nruns, runs, n_dp = nat
    redo = np.flatnonzero(cols < 0)  # -1 too long (device), -2 run overflow
    if n_dp:
        engines.record("native-nw", n_dp)  # real DP runs only (ADVICE r3)
    gapped: dict = {}
    for t in np.flatnonzero(nruns > 0):
        if cols[t] < 0:
            continue
        rr = runs[t, : nruns[t]]
        gapped[int(t)] = (
            [Range(int(s), int(e)) for side, s, e in rr if side == 0],
            [Range(int(s), int(e)) for side, s, e in rr if side == 1],
        )
    ncols = cols.astype(np.int64)
    if len(redo):
        res = align_segments(
            [(ref_np[r0[t]:r1[t]], qry_np[q0[t]:q1[t]]) for t in redo],
            scoring,
        )
        for t, (rg, qg, nc) in zip(redo, res):
            ncols[t] = nc
            if rg or qg:
                gapped[int(t)] = (rg, qg)
            else:
                gapped.pop(int(t), None)
    return ncols, gapped


def banded_align_np(
    a: np.ndarray, b: np.ndarray, width: int = 512, scoring: Scoring = Scoring()
):
    """NumPy mirror of the C++ banded engine (`pm_banded_align`).

    Same band layout and prefix-max closure, vectorized over lanes; used
    as the host fallback for segments too long for the full-DP buckets.
    """
    a_len, b_len = len(a), len(b)
    if abs(a_len - b_len) >= width // 2:
        raise ValueError(
            f"length difference {abs(a_len - b_len)} exceeds band {width//2}"
        )
    half = width // 2
    lanes = np.arange(width)
    NEGv = np.int64(NEG)
    j0 = lanes - half
    prev = np.where((j0 >= 0) & (j0 <= b_len), scoring.gap * j0, NEGv)
    bpad = np.full(b_len + 2 * width, 4, dtype=np.int64)
    bpad[width : width + b_len] = b
    dirs = np.empty((a_len, width), dtype=np.uint8)
    for i in range(1, a_len + 1):
        j = i + lanes - half
        valid = (j >= 1) & (j <= b_len)
        bwin = bpad[i - half - 1 + width : i - half - 1 + width + width]
        sub = np.where(bwin == a[i - 1], scoring.match, scoring.mismatch)
        diag_term = prev + sub
        up = np.roll(prev, -1)
        up_term = np.where(lanes < width - 1, up + scoring.gap, NEGv)
        cand = np.maximum(diag_term, up_term)
        cand = np.where(j == 0, np.maximum(cand, scoring.gap * i), cand)
        cand = np.where(valid | (j == 0), cand, NEGv)
        gj = scoring.gap * j
        run = np.maximum.accumulate(cand - gj)
        dp = np.where(valid, run + gj, np.where(j == 0, scoring.gap * i, NEGv))
        d = np.full(width, LEFT, dtype=np.uint8)
        d[dp == up_term] = UP
        d[dp == diag_term] = DIAG
        dirs[i - 1] = d
        prev = dp
    return traceback_band(dirs, a_len, b_len, width)


def align_long_segment(
    a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring()
):
    """Align one long segment with the host banded engines: native C++
    first, the NumPy mirror as the last resort.  The band width doubles
    from 512 until it covers the length difference."""
    from paramugsy_tpu.ops import engines
    from paramugsy_tpu.ops.native import banded_align_native

    width = 512
    while abs(len(a) - len(b)) >= width // 2:
        width *= 2
    out = banded_align_native(
        np.asarray(a), np.asarray(b), width,
        scoring.match, scoring.mismatch, scoring.gap,
    )
    if out is not None:
        engines.record("native-banded")
        return out
    engines.record("numpy-banded")
    return banded_align_np(a, b, width=width, scoring=scoring)
