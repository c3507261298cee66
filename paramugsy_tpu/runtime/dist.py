"""Multi-host runtime initialization (the SGE-backend replacement).

The reference scales across machines via qsub + rsync-over-ssh staging
(lib/base/sge_interface.ml, scripts/sync_to.sh).  Here ``jax.distributed``
joins the processes into one logical device world; genome-pair batches
shard over the global ``pairs`` mesh axis (paramugsy_tpu.parallel); data
moves over device collectives (NVLink within a host, the network between
hosts), not ssh.

Single-process (one GPU, or CPU) runs skip initialization entirely — the
same seam the reference's ``local`` backend provides.
"""
from __future__ import annotations

import ipaddress
import os
import re
import socket
from dataclasses import dataclass


@dataclass
class DistContext:
    initialized: bool
    process_index: int
    process_count: int
    n_devices: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_card_count() -> int:
    """NVIDIA cards this process may open, found without starting JAX:
    the entries of ``CUDA_VISIBLE_DEVICES`` when it is set, else the
    ``/dev/nvidiaN`` device nodes."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [v.strip() for v in visible.split(",")]
        # CUDA stops at the first invalid entry ("-1" hides every card).
        n = 0
        for v in ids:
            if not v or v.startswith("-"):
                break
            n += 1
        return n
    try:
        return sum(1 for d in os.listdir("/dev") if re.fullmatch(r"nvidia\d+", d))
    except OSError:
        return 0


def coordinator_on_this_host(coordinator: str) -> bool:
    """Whether the coordinator address names this host.  Loopback names,
    this host's name and any IP literal bound to one of its interfaces
    count; other names are not resolved (no DNS lookup)."""
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    if host in ("localhost", socket.gethostname()):
        return True
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        return False
    if ip.is_loopback:
        return True
    family = socket.AF_INET6 if ip.version == 6 else socket.AF_INET
    with socket.socket(family, socket.SOCK_DGRAM) as s:
        try:
            s.bind((host, 0))  # succeeds only for this host's own addresses
        except OSError:
            return False
    return True


def local_device_ids_for(
    coordinator: str,
    num_processes: int | None,
    process_id: int | None,
    n_cards: int,
):
    """The cards a process may use, or None to let JAX decide.

    A JAX process reserves most of every card it sees, so processes that
    share a host must each take their own.  When the coordinator runs on
    this host, the processes are taken to run here too, and process i
    gets card i modulo the host's cards.  Processes that join a
    coordinator elsewhere, and an explicit ``JAX_LOCAL_DEVICE_IDS``, are
    left to JAX (a cluster manager JAX detects, such as Slurm or Open
    MPI, gives each process its local card itself).
    """
    if os.environ.get("JAX_LOCAL_DEVICE_IDS") or process_id is None or n_cards < 1:
        return None
    if (num_processes or 0) < 2 or not coordinator_on_this_host(coordinator):
        return None
    return [process_id % n_cards]


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> DistContext:
    """Join the multi-process world if configured; no-op for one process.

    Configuration comes from the arguments or the environment:
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID`` (or a cluster manager JAX detects).  Must run
    before anything opens a device; a second call returns the topology
    of the first.  Returns the process topology.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    initialized = jax.distributed.is_initialized()
    if coordinator and not initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids_for(
                coordinator, num_processes, process_id, local_card_count()
            ),
        )
        initialized = True
    return DistContext(
        initialized=initialized,
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        n_devices=len(jax.devices()),
    )


def local_pair_slice(n_pairs: int, ctx: DistContext) -> slice:
    """The contiguous slice of a global pair list this process owns."""
    per = (n_pairs + ctx.process_count - 1) // ctx.process_count
    start = ctx.process_index * per
    return slice(start, min(start + per, n_pairs))
