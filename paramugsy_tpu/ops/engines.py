"""DP engine selection and usage accounting.

A broken fast path must not degrade to the slow one without a trace.
This module centralizes the policy:

* `record()` counts which engine actually ran (tests pin the expectation
  that the native/device engines run when available);
* engine choices are logged once per process;
* genuine load failures of an *existing* native library raise instead of
  silently degrading (`ops.native.load`).

Long segments run on the device wavefront whenever JAX's default backend
is an accelerator, and on the host banded engine on the CPU.
"""
from __future__ import annotations

import logging

log = logging.getLogger("paramugsy.engines")

# engine name -> number of segment batches it aligned this process
COUNTS: dict[str, int] = {}
_logged: set[str] = set()


def record(engine: str, n: int = 1) -> None:
    COUNTS[engine] = COUNTS.get(engine, 0) + n
    if engine not in _logged:
        _logged.add(engine)
        log.info("DP engine in use: %s", engine)


def reset_counts() -> None:
    COUNTS.clear()


def record_seedcluster(n: int = 1) -> None:
    """Count genome pairs through the fused seeding/clustering dispatch,
    by backend — the pair pipeline's heavy compute, so the engine counts
    show where the work went rather than only the segment DPs."""
    import jax

    record(f"seedcluster-{jax.default_backend()}", n)


def device_dp_enabled() -> bool:
    """Should long-segment extension run on the device?"""
    import jax

    return jax.default_backend() != "cpu"
