"""Batched banded global alignment on the device: the anti-diagonal
wavefront in plain `lax`.

Coordinates: cell (i, j) of the DP matrix lives at step d = i + j, lane
w = j - i + half of a band of `width` lanes.  Its three predecessors are

    diag (i-1, j-1) -> step d-2, same lane
    up   (i-1, j  ) -> step d-1, lane w+1
    left (i,   j-1) -> step d-1, lane w-1

so one step has no dependency inside itself: it is a few shifted
elementwise ops over the band.  The character windows advance one lane
per step as well: awin shifts right taking a new character at lane 0,
bwin shifts left taking one at lane width-1.

Nothing is masked by parity, rectangle or boundary.  Off-parity and
out-of-rectangle lanes compute values that never reach an in-rectangle
cell: the pad codes differ per side (4 for a, 5 for b), so a comparison
outside a sequence scores `mismatch` and such values decay from the NEG
start, while the boundary rows dp(i, 0) = gap*i and dp(0, j) = gap*j
emerge from the up/left chains seeded by dp(0, 0) = 0.

Directions (0 = diag, 1 = up, 2 = left; diag wins ties, then up) are
packed 16 steps per int32 word, step d in bits 2*((d-1) % 16), and traced
back on the host (`native.wavefront_traceback_native`, with
`extend.traceback_wavefront` as its reference).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from paramugsy_tpu.ops.extend import DIAG, LEFT, UP, traceback_wavefront

NEG = -(10**8)  # plain int: a jnp scalar would be a captured constant
STEPS_PER_WORD = 16


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap"))
def wavefront_dirs(a_new, b_new, awin0, bwin0, *, match=2, mismatch=-3, gap=-4):
    """Forward banded DP of a batch of pairs.

    a_new/b_new: int8 [batch, steps] characters entering the windows at
    steps 1..steps (steps a multiple of 16); awin0/bwin0: int8 [batch,
    width] windows before step 1.  Returns packed directions int32
    [steps // 16, batch, width].
    """
    steps = a_new.shape[1]
    width = awin0.shape[1]
    half = width // 2
    neg1 = jnp.full((1,), NEG, jnp.int32)

    def one_pair(a_new, b_new, awin, bwin):
        def group(carry, chars):
            dp1, dp2, awin, bwin = carry  # dp of steps d-1 and d-2
            word = jnp.zeros((width,), jnp.int32)
            for s in range(STEPS_PER_WORD):
                awin = jnp.concatenate([chars[0][s : s + 1], awin[:-1]])
                bwin = jnp.concatenate([bwin[1:], chars[1][s : s + 1]])
                diag = dp2 + jnp.where(awin == bwin, match, mismatch)
                up = jnp.concatenate([dp1[1:] + gap, neg1])
                left = jnp.concatenate([neg1, dp1[:-1] + gap])
                dp = jnp.maximum(jnp.maximum(diag, up), left)
                code = jnp.where(
                    dp == diag, DIAG, jnp.where(dp == up, UP, LEFT)
                )
                word = word | (code << (2 * s))
                dp1, dp2 = dp, dp1
            return (dp1, dp2, awin, bwin), word

        lanes = jnp.arange(width)
        dp0 = jnp.where(lanes == half, 0, NEG).astype(jnp.int32)
        carry = (dp0, jnp.full((width,), NEG, jnp.int32), awin, bwin)
        chars = (
            a_new.reshape(steps // STEPS_PER_WORD, STEPS_PER_WORD),
            b_new.reshape(steps // STEPS_PER_WORD, STEPS_PER_WORD),
        )
        _, words = lax.scan(group, carry, chars)
        return words

    return jax.vmap(one_pair, out_axes=1)(a_new, b_new, awin0, bwin0)


def wavefront_streams(pairs, steps: int, width: int):
    """Host input assembly for `wavefront_dirs` (a padded with 4, b with 5)."""
    half = width // 2
    n = len(pairs)
    a_new = np.empty((n, steps), np.int8)
    b_new = np.empty((n, steps), np.int8)
    awin = np.empty((n, width), np.int8)
    bwin = np.empty((n, width), np.int8)

    def stream(seq, idx, pad):
        if len(seq) == 0:
            return np.full(idx.shape, pad, np.int8)
        inside = (idx >= 0) & (idx < len(seq))
        return np.where(inside, seq[np.clip(idx, 0, len(seq) - 1)], pad)

    d_idx = np.arange(1, steps + 1)
    w_idx = np.arange(width)
    for p, (a, b) in enumerate(pairs):
        # Step d's entering characters: awin[0] = a[(d + half)/2 - 1] and
        # bwin[W-1] = b[(d + W-1 - half)/2 - 1] (floor; pad outside).
        a_new[p] = stream(a, (d_idx + half) // 2 - 1, 4)
        b_new[p] = stream(b, (d_idx + width - 1 - half) // 2 - 1, 5)
        awin[p] = stream(a, (half - w_idx) // 2 - 1, 4)
        bwin[p] = stream(b, (w_idx - half) // 2 - 1, 5)
    return a_new, b_new, awin, bwin


def _traceback_many(dirs: np.ndarray, pairs, width: int):
    """Trace back every pair of one launch: native C++ when the library
    is loaded, else the Python reference walk."""
    from paramugsy_tpu.ops.native import wavefront_traceback_native

    a_lens = np.fromiter((len(a) for a, _ in pairs), np.int32, len(pairs))
    b_lens = np.fromiter((len(b) for _, b in pairs), np.int32, len(pairs))
    nat = wavefront_traceback_native(dirs, a_lens, b_lens, width)
    if nat is not None:
        return nat
    return [
        traceback_wavefront(dirs[:, p, :], len(a), len(b), width)
        for p, (a, b) in enumerate(pairs)
    ]


def wavefront_align_many(
    segs: list[tuple[np.ndarray, np.ndarray]],
    *,
    match: int = 2,
    mismatch: int = -3,
    gap: int = -4,
    batch: int = 64,
    base_width: int = 512,
    min_steps: int = 256,
):
    """Align any number of segment pairs on the device.

    Pairs are grouped by band width (doubling from `base_width` until the
    length difference fits, as `extend.align_long_segment` does) and by
    step count rounded up to a power of two, then launched `batch` at a
    time.  Returns (ref_gap_runs, query_gap_runs, n_columns) per pair, in
    input order.
    """
    results: list = [None] * len(segs)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (a, b) in enumerate(segs):
        if len(a) + len(b) == 0:
            results[i] = ([], [], 0)
            continue
        width = base_width
        while abs(len(a) - len(b)) >= width // 2:
            width *= 2
        # Power-of-two step buckets bound the number of compiled shapes.
        steps = max(min_steps, 1 << (len(a) + len(b) - 1).bit_length())
        groups.setdefault((width, steps), []).append(i)
    for (width, steps), idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), batch):
            part = idxs[lo : lo + batch]
            # Launch the full batch when the part mostly fills it, else the
            # part rounded up to a multiple of 8: few compiled batch sizes.
            n_b = batch if len(part) > batch // 2 else -(-len(part) // 8) * 8
            empty = np.empty(0, np.int8)
            pairs = [segs[i] for i in part] + [(empty, empty)] * (n_b - len(part))
            streams = wavefront_streams(pairs, steps, width)
            dirs = np.asarray(
                wavefront_dirs(
                    *map(jnp.asarray, streams),
                    match=match, mismatch=mismatch, gap=gap,
                )
            )
            outs = _traceback_many(dirs, pairs[: len(part)], width)
            for i, out in zip(part, outs):
                results[i] = out
    return results
