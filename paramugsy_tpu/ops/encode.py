"""DNA encoding for on-device alignment.

Genomes are int8 tensors: A=0, C=1, G=2, T=3, anything else (N, IUPAC
ambiguity) = 4.  All compute kernels operate on these packed tensors; text
only exists at ingest/emit (the reference pipes FASTA text between external
binaries; we stage tensors into HBM once).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Host-side LUT: byte -> code.
_LUT = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _LUT[ord(c)] = i
    _LUT[ord(c.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """Sequence text -> int8 codes (host)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DECODE[np.asarray(codes)].tobytes().decode()


def revcomp_codes(codes):
    """Reverse complement in code space: A<->T (0<->3), C<->G (1<->2), N->N."""
    comp = jnp.where(codes < 4, 3 - codes, codes)
    return comp[::-1]


def revcomp_codes_np(codes: np.ndarray) -> np.ndarray:
    """Host (NumPy) reverse complement — avoids a device round trip."""
    return np.where(codes < 4, 3 - codes, codes).astype(np.int8)[::-1]


def pad_to(codes: np.ndarray, size: int, fill: int = 4) -> np.ndarray:
    """Pad with N codes to a static bucket size (shape stability under jit)."""
    if len(codes) > size:
        raise ValueError(f"sequence length {len(codes)} exceeds bucket {size}")
    out = np.full(size, fill, dtype=np.int8)
    out[: len(codes)] = codes
    return out


def bucket_size(n: int, minimum: int = 1 << 12) -> int:
    """Next power-of-two bucket (limits the number of compiled variants)."""
    size = minimum
    while size < n:
        size <<= 1
    return size


def pack2_np(codes: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack int8 codes into 2 bits each for the host->device transfer.

    Non-ACGT codes (4) are packed as 0 and reported separately as a sparse
    position list so the device can restore them; the transfer shrinks 4x.
    Returns (packed uint8 [size//4], n_positions int32 [num_N]).
    """
    n = len(codes)
    if n > size:
        raise ValueError(f"sequence length {n} exceeds bucket {size}")
    buf = np.zeros(size, dtype=np.uint8)
    buf[:n] = np.where(codes < 4, codes, 0).astype(np.uint8)
    b = buf.reshape(-1, 4)
    packed = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(
        np.uint8
    )
    n_pos = np.flatnonzero(np.asarray(codes) >= 4).astype(np.int32)
    return packed, n_pos


def _unpack_core(packed, n_eff, total):
    shifts = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    x = ((packed[:, None] >> shifts[None, :]) & jnp.uint8(3)).astype(jnp.int8)
    x = x.reshape(total)
    i = jnp.arange(total, dtype=jnp.int32)
    return jnp.where(i < n_eff, x, jnp.int8(4))


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(2,))
def _unpack2(packed, n_eff, total):
    return _unpack_core(packed, n_eff, total)


@_partial(jax.jit, static_argnums=(2,))
def _unpack2_n(packed, n_eff, total, n_positions):
    # n_positions is padded with `total` (out of range) -> dropped.
    x = _unpack_core(packed, n_eff, total)
    return x.at[n_positions].set(jnp.int8(4), mode="drop")


def device_codes_packed(np_codes: np.ndarray, total: int):
    """Upload codes as a 2-bit packed buffer; unpack to int8 on device.

    Equivalent to ``jnp.asarray(pad_to(np_codes, total))`` with a 4x
    smaller transfer.
    """
    packed, n_pos = pack2_np(np_codes, total)
    if n_pos.size:
        m = 1 << max(4, int(n_pos.size - 1).bit_length())
        pad = np.full(m, total, dtype=np.int32)
        pad[: n_pos.size] = n_pos
        return _unpack2_n(
            jnp.asarray(packed), jnp.int32(len(np_codes)), total, jnp.asarray(pad)
        )
    return _unpack2(jnp.asarray(packed), jnp.int32(len(np_codes)), total)


def kmer_codes(codes, k: int):
    """Packed 2-bit k-mer codes and validity at every window start.

    Returns (kmers[uint32, N], valid[bool, N]); positions with fewer than k
    bases remaining or any non-ACGT base in the window are invalid (their
    code is forced to 0).  k <= 16.
    """
    if not 1 <= k <= 16:
        raise ValueError("k must be in [1, 16]")
    n = codes.shape[0]
    base = jnp.where(codes < 4, codes, 0).astype(jnp.uint32)
    bad = (codes >= 4).astype(jnp.int32)
    acc = jnp.zeros(n, dtype=jnp.uint32)
    badc = jnp.zeros(n, dtype=jnp.int32)
    for j in range(k):
        shifted = jnp.roll(base, -j)
        acc = (acc << jnp.uint32(2)) | shifted
        badc = badc + jnp.roll(bad, -j)
    idx = jnp.arange(n)
    valid = (idx <= n - k) & (badc == 0)
    return jnp.where(valid, acc, 0), valid


def kmer_canonical(codes, k: int):
    """Canonical k-mer codes: min(forward, revcomp) per window.

    Returns (canon[uint32, N], strand[bool, N], valid[bool, N]) where
    strand is True when the revcomp form is the canonical one.  Joining
    canonical streams lets both-strand matching share ONE sorted array
    (a forward match has equal strand bits on both sides, a reverse match
    opposite bits) — a third fewer elements through the sort network than
    separate fwd + revcomp query streams.  k <= 15 keeps the code in 30
    bits so callers can pack a validity flag alongside it.
    """
    if not 1 <= k <= 16:
        raise ValueError("k must be in [1, 16]")
    n = codes.shape[0]
    base = jnp.where(codes < 4, codes, 0).astype(jnp.uint32)
    bad = (codes >= 4).astype(jnp.int32)
    fwd = jnp.zeros(n, dtype=jnp.uint32)
    rc = jnp.zeros(n, dtype=jnp.uint32)
    badc = jnp.zeros(n, dtype=jnp.int32)
    for j in range(k):
        b = jnp.roll(base, -j)
        fwd = (fwd << jnp.uint32(2)) | b
        rc = rc | ((jnp.uint32(3) - b) << jnp.uint32(2 * j))
        badc = badc + jnp.roll(bad, -j)
    idx = jnp.arange(n)
    valid = (idx <= n - k) & (badc == 0)
    strand = rc < fwd
    canon = jnp.where(valid, jnp.minimum(fwd, rc), 0)
    return canon, strand, valid
