"""Anchor clustering + chaining (the nucmer ``mgaps`` role).

Two-level device/host design instead of the classic sequential greedy DP:

1. **Band clustering (device, fully parallel)** — seeds arrive sorted by
   (diagonal, qpos) from `find_seeds`.  We re-sort by (diagonal band, qpos)
   and split runs wherever the query gap or in-band diagonal drift exceeds
   the limits.  Per-cluster summaries come from segment reductions written
   as cumulative ops over the sorted order (no scatters).

2. **Cluster chaining (host, tiny)** — clusters are few (<= thousands);
   an exact O(C^2) weighted DP chains them with nucmer-like gap/diagonal
   constraints.  This recovers alignments whose indels cross band
   boundaries.

The reference's knobs map directly: ``-c`` min cluster length, ``-g`` max
gap, ``-D`` diagonal difference (nucmer defaults 65/90/5; see
lib/nucmer/mugsy_nucmer.ml flags).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

BIG = np.int32(2**31 - 1)  # NumPy: importing this module opens no device


class Clusters(NamedTuple):
    """Per-seed cluster assignment + per-cluster summaries (device)."""

    # per-seed (same order as the sorted seeds used for clustering)
    seed_rpos: jnp.ndarray
    seed_qpos: jnp.ndarray
    seed_len: jnp.ndarray
    seed_cluster: jnp.ndarray  # int32 cluster id (dense, stable) or -1
    # per-cluster [max_clusters]
    c_rstart: jnp.ndarray
    c_rend: jnp.ndarray
    c_qstart: jnp.ndarray
    c_qend: jnp.ndarray
    c_weight: jnp.ndarray  # total matched bases
    c_nseeds: jnp.ndarray
    c_first: jnp.ndarray  # index of the cluster's first seed (sorted order)
    c_mask: jnp.ndarray
    n_clusters: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("band", "max_gap", "max_clusters")
)
def cluster_seeds(
    rpos,
    qpos,
    length,
    mask,
    *,
    band: int = 16,
    max_gap: int = 90,
    max_clusters: int = 4096,
) -> Clusters:
    """Group seeds into near-collinear clusters."""
    m = rpos.shape[0]
    diag = rpos - qpos
    band_id = jnp.where(mask, diag // band, BIG)

    # Sort by (band, qpos); invalid seeds go last.
    band_id, qpos, rpos, length, mask_i = lax.sort(
        (band_id, qpos, rpos, length, mask.astype(jnp.int32)), num_keys=2
    )
    mask = mask_i == 1
    diag = rpos - qpos

    prev_band = jnp.roll(band_id, 1)
    prev_qend = jnp.roll(qpos + length, 1)
    prev_rpos = jnp.roll(rpos, 1)
    idx = jnp.arange(m, dtype=jnp.int32)
    new_cluster = mask & (
        (idx == 0)
        | (band_id != prev_band)
        | (qpos - prev_qend > max_gap)
        | (rpos <= prev_rpos)  # enforce monotonicity in ref
    )
    cluster_id = jnp.cumsum(new_cluster.astype(jnp.int32)) - 1
    cluster_id = jnp.where(mask, cluster_id, -1)

    # Segment reductions over contiguous cluster runs.
    start_idx = lax.cummax(jnp.where(new_cluster, idx, -1), axis=0)
    cum_w = jnp.cumsum(jnp.where(mask, length, 0))
    cum_n = jnp.cumsum(mask.astype(jnp.int32))

    is_end = mask & (
        (idx == m - 1) | jnp.roll(new_cluster, -1) | ~jnp.roll(mask, -1)
    )

    def seg_sum(cum, lo, hi):
        lo_v = jnp.where(lo > 0, cum[jnp.maximum(lo - 1, 0)], 0)
        return cum[hi] - lo_v

    # Cluster summary values, defined at end elements.
    w = seg_sum(cum_w, start_idx, idx)
    nseeds = seg_sum(cum_n, start_idx, idx)
    rstart = rpos[jnp.maximum(start_idx, 0)]
    qstart = qpos[jnp.maximum(start_idx, 0)]
    rend = rpos + length - 1
    qend = qpos + length - 1

    # Compact summaries to [max_clusters] by sorting (is_end desc, idx asc).
    key = jnp.where(is_end, 0, 1).astype(jnp.int32)
    _, o_rs, o_re, o_qs, o_qe, o_w, o_n, o_first, o_mask = lax.sort(
        (key, rstart, rend, qstart, qend, w, nseeds,
         jnp.maximum(start_idx, 0), is_end.astype(jnp.int32)),
        num_keys=1,
        is_stable=True,
    )
    take = min(max_clusters, m)

    def cut(x):
        return lax.dynamic_slice_in_dim(x, 0, take)

    return Clusters(
        seed_rpos=rpos,
        seed_qpos=qpos,
        seed_len=length,
        seed_cluster=cluster_id,
        c_rstart=cut(o_rs),
        c_rend=cut(o_re),
        c_qstart=cut(o_qs),
        c_qend=cut(o_qe),
        c_weight=cut(o_w),
        c_nseeds=cut(o_n),
        c_first=cut(o_first),
        c_mask=cut(o_mask) == 1,
        n_clusters=jnp.sum(is_end.astype(jnp.int32)),
    )


def chain_clusters(
    c_rstart: np.ndarray,
    c_rend: np.ndarray,
    c_qstart: np.ndarray,
    c_qend: np.ndarray,
    c_weight: np.ndarray,
    *,
    max_join_gap: int = 200,
    max_join_diagdiff: int = 500,
    min_chain_weight: int = 65,
) -> list[list[int]]:
    """Exact O(C^2) chaining of cluster summaries (host).

    Returns chains as lists of cluster indices, ordered along the ref.
    ``max_join_gap`` plays nucmer's breaklen role (-b 200): clusters
    further apart than this are separate alignments.
    """
    C = len(c_rstart)
    if C == 0:
        return []
    order = np.lexsort((c_qstart, c_rstart))
    rs, re_, qs, qe, w = (
        c_rstart[order].astype(np.int64),
        c_rend[order].astype(np.int64),
        c_qstart[order].astype(np.int64),
        c_qend[order].astype(np.int64),
        c_weight[order].astype(np.int64),
    )
    from paramugsy_tpu.ops.native import chain_clusters_native

    nat = chain_clusters_native(
        rs, re_, qs, qe, w, max_join_gap, max_join_diagdiff
    )
    if nat is not None:
        score, parent = nat
    else:
        score = w.copy()
        parent = np.full(C, -1, dtype=np.int64)
        for i in range(1, C):
            gap_r = rs[i] - re_[:i]
            gap_q = qs[i] - qe[:i]
            dd = np.abs(gap_r - gap_q)
            valid = (
                (re_[:i] < rs[i])
                & (qe[:i] < qs[i])
                & (np.maximum(gap_r, gap_q) <= max_join_gap)
                & (dd <= max_join_diagdiff)
            )
            if valid.any():
                cand = np.where(valid, score[:i] - dd, np.int64(-(10**12)))
                j = int(np.argmax(cand))
                if cand[j] > 0:
                    score[i] = w[i] + cand[j]
                    parent[i] = j

    used = np.zeros(C, dtype=bool)
    chains: list[list[int]] = []
    for i in np.argsort(-score):
        if used[i] or score[i] < min_chain_weight:
            continue
        chain = []
        j = int(i)
        while j != -1 and not used[j]:  # truncate at already-claimed clusters
            chain.append(j)
            j = int(parent[j])
        if not chain or w[chain].sum() < min_chain_weight:
            continue
        for j in chain:
            used[j] = True
        chains.append([int(order[j]) for j in reversed(chain)])
    return chains
