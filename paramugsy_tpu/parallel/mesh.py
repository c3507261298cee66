"""Device mesh construction for multi-chip runs.

The reference scaled across an SGE cluster with qsub + rsync staging
(SURVEY section 2.5); here scale comes from a jax.sharding.Mesh whose axes
are

* ``pairs`` — data parallelism over genome pairs (the P1 strategy:
  all-pairs nucmer fan-out);
* ``kdim``  — sharding of the k-mer sketch dimension for the guide-tree
  distance matmul (contraction over the sharded axis -> XLA inserts the
  psum; on one host of H100s it runs over NVLink, all to all).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_pairs: int | None = None, n_kdim: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_pairs is None:
        n_pairs = n // n_kdim
    if n_pairs * n_kdim != n:
        raise ValueError(f"mesh {n_pairs}x{n_kdim} != {n} devices")
    arr = np.array(devices).reshape(n_pairs, n_kdim)
    return Mesh(arr, ("pairs", "kdim"))


def pair_sharding(mesh: Mesh):
    """Sharding for a leading pairs axis."""
    return NamedSharding(mesh, P("pairs"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
