"""Genome distance estimation on device (replaces the MUSCLE subprocess).

The reference shells out to ``muscle -clusteronly -tree1`` (k-mer distance
clustering) to get a guide tree (lib/base/mugsy_guide_tree.ml:72-90).  We
compute k-mer *presence sketches* — one dense {0,1} vector of dimension 4^k
per genome — and estimate pairwise Jaccard similarity with a single matmul
over the genome axis:

    inter = S @ S.T          (G x D) @ (D x G), float32 on the device
    union = |A| + |B| - inter      (the rest on the host, float64)
    J = inter / union
    mash distance D = -1/k * ln(2J / (1 + J))      (Ondov et al. 2016)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from paramugsy_tpu.ops.encode import kmer_codes


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_sketch(codes, k: int = 8):
    """Dense presence vector over the 4^k k-mer space (float32 [4^k]).

    Scatter-light: sorting the codes and compacting the first-occurrence
    values to a static 4^k-slice leaves a scatter of at most 4^k
    one-writes instead of one per position; the presence vector is the
    same either way.
    """
    km, valid = kmer_codes(codes, k)
    dim = 4**k
    n = km.shape[0]
    vals = jnp.where(valid, km, dim)  # invalid -> out of range, dropped
    s = jnp.sort(vals)
    first = jnp.concatenate([jnp.array([True]), s[1:] != s[:-1]])
    uniq = jnp.sort(jnp.where(first, s, dim))
    uniq = uniq[: min(dim, n)]
    sketch = (
        jnp.zeros(dim + 1, dtype=jnp.float32)
        .at[uniq]
        .set(1.0, mode="drop")[:dim]
    )
    return sketch


@jax.jit
def intersection_matrix(sketches):
    """Pairwise k-mer set intersections |A & B| from presence sketches
    [G, D], as float32 counts.

    Exact on every backend, TF32 included: the inputs are 0 or 1, which
    TF32 represents exactly, and each dot product is a count below 2^24,
    which the float32 accumulator holds exactly.
    """
    return jnp.dot(sketches, sketches.T, preferred_element_type=jnp.float32)


def jaccard_of_intersections(inter) -> np.ndarray:
    """Jaccard similarity from an intersection matrix, on the host in
    float64: the G x G division is tiny, and the GPU's float32 division
    may differ from IEEE by an ulp, which would make the guide tree
    depend on the device."""
    inter = np.asarray(inter, dtype=np.float64)
    sizes = np.diag(inter)
    union = sizes[:, None] + sizes[None, :] - inter
    return inter / np.maximum(union, 1.0)


def jaccard_matrix(sketches) -> np.ndarray:
    """Pairwise Jaccard similarity from presence sketches [G, D]."""
    return jaccard_of_intersections(intersection_matrix(sketches))


def mash_distance(jaccard: np.ndarray, k: int = 8) -> np.ndarray:
    j = np.clip(np.asarray(jaccard), 1e-9, 1.0)
    d = -np.log(2 * j / (1 + j)) / k
    np.fill_diagonal(d, 0.0)
    return np.maximum(d, 0.0)


@functools.partial(jax.jit, static_argnames=("k",))
def _sketch_intersections_batch(codes_batch, k: int = 8):
    """One dispatch for the whole genome set: vmapped sketches + the
    intersection matmul, one upload for all genomes; rows are padded
    with N (code 4), whose k-mer windows are invalid, so padding never
    enters a sketch."""
    sketches = jax.vmap(lambda c: kmer_sketch(c, k=k))(codes_batch)
    return intersection_matrix(sketches)


def distance_matrix(genome_codes: list[np.ndarray], k: int = 8) -> np.ndarray:
    """Pairwise Mash distances for a list of encoded genomes."""
    from paramugsy_tpu.ops.encode import bucket_size

    n_max = bucket_size(max(len(c) for c in genome_codes))
    batch = np.full((len(genome_codes), n_max), 4, dtype=np.int8)
    for i, c in enumerate(genome_codes):
        batch[i, : len(c)] = c
    inter = _sketch_intersections_batch(jnp.asarray(batch), k=k)
    return mash_distance(jaccard_of_intersections(inter), k=k)
