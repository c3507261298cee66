"""Concurrent job-tree execution (the job_processor role).

Reproduces the reference engine's structure (lib/base/job_processor.ml):

* the tree is walked concurrently — a merge node's pairwise fan-out starts
  *in parallel with* its children's subtree execution (P4 overlap,
  job_processor.ml:251-266);
* pairwise alignments are chunked ``chunk_size`` at a time
  (run_nucmers, job_processor.ml:128-154);
* task priority is tree depth (deeper first), through the bounded
  PriorityScheduler;
* failures propagate up and abort the run (job_processor.ml:330-333).
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Optional

from paramugsy_tpu.formats.maf import MafBlock
from paramugsy_tpu.pipeline import (
    Aligner,
    Genome,
    PipelineConfig,
    fake_mugsy_blocks,
    genome_pair_deltas,
)
from paramugsy_tpu.lcb.merge import merge_blocks
from paramugsy_tpu.runtime.scheduler import PriorityScheduler, spawn
from paramugsy_tpu.tree.job_tree import JobTree


def _chunks(xs: list, size: int) -> list[list]:
    return [xs[i : i + size] for i in range(0, len(xs), max(1, size))]


class JobExecutor:
    """Schedules the job tree over a bounded-slot priority scheduler."""

    def __init__(
        self,
        genomes: list[Genome],
        cfg: PipelineConfig | None = None,
        run_size: int = 4,
        chunk_size: int = 16,
        scheduler: Optional[PriorityScheduler] = None,
        on_task: Optional[Callable[[str, str], None]] = None,
        store=None,  # runtime.artifacts.ArtifactStore
        ownership=None,  # runtime.artifacts.PairOwnership
        retries: int = 1,  # pair-task attempts (local_interface.ml retry role)
        failover_after: float = 300.0,  # re-own a silent owner's pair after this
    ):
        self.cfg = cfg or PipelineConfig()
        self.genomes = {g.name: g for g in genomes}
        self.sched = scheduler or PriorityScheduler(run_size)
        self.chunk_size = chunk_size
        # Device-resident padded genome codes shared across pair tasks
        # (dict writes are atomic under the GIL; a duplicate put is benign).
        self._device_cache: dict = {}
        self._uid = 0
        self._on_task = on_task or (lambda phase, name: None)
        self.store = store
        self.ownership = ownership
        self.retries = max(1, retries)
        self.failover_after = failover_after

    def _next_uid(self) -> str:
        self._uid += 1
        return f"n{self._uid:04d}"

    # ------------------------------------------------------------------
    def _pair_deltas(self, a: str, b: str):
        from paramugsy_tpu.utils.obs import METRICS
        """One pair's deltas, via the store when available.

        With a store + ownership: owners compute and publish, others block
        on the shared artifact (the multi-host exchange).
        """
        if self.store is not None:
            if self.store.has_pair(a, b):
                self._on_task("nucmer-cached", f"{a}~{b}")
                return self.store.load_pair(a, b)
            if self.ownership is not None and not self.ownership.owns(a, b):
                self._on_task("nucmer-wait", f"{a}~{b}")
                return self.store.wait_pair(
                    a, b,
                    failover=lambda: self._compute_pair(a, b),
                    failover_after=self.failover_after,
                )
        self._on_task("nucmer", f"{a}~{b}")
        if self.store is not None:
            # Claim heartbeat: waiters on other hosts see we're alive and
            # don't fire failover on a slow (not dead) owner.
            with self.store.claim_pair(a, b):
                deltas = self._compute_pair(a, b)
                self.store.save_pair(a, b, deltas)
        else:
            deltas = self._compute_pair(a, b)
        return deltas

    def _compute_pair(self, a: str, b: str):
        from paramugsy_tpu.utils.obs import METRICS

        with METRICS.phase("pairwise", items=1):
            return genome_pair_deltas(
                self.genomes[a], self.genomes[b], self.cfg.align,
                self._device_cache,
            )

    def _pair_chunk_task(self, pairs: list[tuple[str, str]]):
        """One chunk = ONE device dispatch for every uncached pair.

        Cached/foreign pairs resolve through the store; the rest batch
        through `genome_pair_deltas_batch` (a vmapped kernel launch + one
        packed transfer).  On failure the chunk degrades to the per-pair
        path, which carries the retry policy.
        """
        from paramugsy_tpu.pipeline import genome_pair_deltas_batch
        from paramugsy_tpu.utils.obs import METRICS

        out = []
        compute: list[tuple[str, str]] = []
        for a, b in pairs:
            if self.store is not None and self.store.has_pair(a, b):
                self._on_task("nucmer-cached", f"{a}~{b}")
                out.extend(self.store.load_pair(a, b))
            elif self.store is not None and self.ownership is not None and not self.ownership.owns(a, b):
                out.extend(self._pair_deltas(a, b))  # waits on the store
            else:
                compute.append((a, b))
        if len(compute) > 1:
            try:
                import contextlib

                for a, b in compute:
                    self._on_task("nucmer", f"{a}~{b}")
                with contextlib.ExitStack() as claims:
                    if self.store is not None:
                        for a, b in compute:
                            claims.enter_context(self.store.claim_pair(a, b))
                    with METRICS.phase("pairwise", items=len(compute)):
                        deltas_list = genome_pair_deltas_batch(
                            [(self.genomes[a], self.genomes[b]) for a, b in compute],
                            self.cfg.align,
                            self._device_cache,
                        )
                    # Saves may fail mid-loop; `out` is only extended after
                    # every save succeeds, so the per-pair fallback below
                    # never duplicates entries already emitted.
                    for (a, b), deltas in zip(compute, deltas_list):
                        if self.store is not None:
                            self.store.save_pair(a, b, deltas)
                out.extend(e for deltas in deltas_list for e in deltas)
                return out
            except Exception:
                import logging

                logging.getLogger("paramugsy.executor").warning(
                    "batched pair dispatch failed; retrying per pair",
                    exc_info=True,
                )
        for a, b in compute:
            for attempt in range(self.retries):
                try:
                    out.extend(self._pair_deltas(a, b))
                    break
                except Exception:
                    if attempt + 1 >= self.retries:
                        raise
        return out

    def _submit_pairs(self, pairs, priority) -> list[Future]:
        # Pairs owned by another host are *waited for*, never computed —
        # and a wait must not occupy a bounded scheduler slot, or two
        # hosts can deadlock with all slots blocked on each other.
        if self.ownership is not None and self.store is not None:
            owned = [
                p for p in pairs
                if self.store.has_pair(*p) or self.ownership.owns(*p)
            ]
            waited = [p for p in pairs if p not in owned]
        else:
            owned, waited = list(pairs), []
        futs = [
            self.sched.submit(
                self._pair_chunk_task, chunk, priority=priority,
                name=f"pairs[{len(chunk)}]",
            )
            for chunk in _chunks(owned, self.chunk_size)
        ]
        if waited:
            futs.append(
                spawn(self._pair_chunk_task, waited, name="pairs-wait")
            )
        return futs

    def _merge_node(
        self,
        left_names: list[str],
        right_names: list[str],
        left_fut: Future,
        right_fut: Future,
        delta_futs: list[Future],
        priority: int,
    ) -> list[MafBlock]:
        lb = left_fut.result()
        rb = right_fut.result()
        deltas = []
        for f in delta_futs:
            deltas.extend(f.result())
        # The merge breaks ties by input order, so feed it the pairs in
        # the job tree's order, however each pair arrived (computed here,
        # cached, or waited for from another process): the output must
        # not depend on the process count.
        left_pos = {s: i for i, g in enumerate(left_names) for s in self.genomes[g].seqs}
        right_pos = {s: i for i, g in enumerate(right_names) for s in self.genomes[g].seqs}
        deltas.sort(key=lambda e: (left_pos[e.ref_name], right_pos[e.query_name]))
        names = left_names + right_names
        uid = self._next_uid()
        from paramugsy_tpu.utils.obs import METRICS

        def run_merge():
            with METRICS.phase("merge", items=1):
                return merge_blocks(
                    lb,
                    rb,
                    deltas,
                    basename_left=f"l{uid}",
                    basename_right=f"r{uid}",
                    min_length=self.cfg.min_length,
                    emit_unique=self.cfg.emit_unique,
                    refine=self.cfg.refine,
                    refine_max_cols=self.cfg.refine_max_cols,
                    chain_gap=self.cfg.chain_gap,
                )

        # Merge nodes are distributed too: one deterministic owner per
        # node computes it and publishes through the store; other hosts
        # block on the artifact (with dead-owner failover).  The
        # reference's cluster also ran merge tasks as distributed jobs
        # (lib/base/job_processor.ml:247-285); round 2 replicated every
        # merge on every host.
        if (
            self.store is not None
            and self.ownership is not None
            and not self.ownership.owns_node(names)
        ):
            self._on_task("merge-wait", "+".join(names))
            return self.store.wait_node(
                names, failover=run_merge, failover_after=self.failover_after
            )
        self._on_task("merge", uid)
        if self.store is not None:
            with self.store.claim_node(names):
                merge_fut = self.sched.submit(
                    run_merge, priority=priority, name=f"merge-{uid}",
                )
                blocks = merge_fut.result()
                self.store.save_node(names, blocks)
        else:
            merge_fut = self.sched.submit(
                run_merge, priority=priority, name=f"merge-{uid}",
            )
            blocks = merge_fut.result()
        return blocks

    def _process(self, node: JobTree, priority: int) -> Future:
        if node.kind == "fake_mugsy":
            return self.sched.submit(
                fake_mugsy_blocks, self.genomes[node.genomes[0]],
                priority=priority, name=f"fake:{node.genomes[0]}",
            )
        if node.kind == "mugsy":
            # binary merge over the ordered leaf genomes
            order = node.genomes
            if len(order) == 1:
                return self._process(
                    JobTree(kind="fake_mugsy", genomes=order), priority
                )
            half = len(order) // 2
            left = JobTree(kind="mugsy", genomes=order[:half]) if half > 1 else JobTree(kind="fake_mugsy", genomes=order[:half])
            right = JobTree(kind="mugsy", genomes=order[half:]) if len(order) - half > 1 else JobTree(kind="fake_mugsy", genomes=order[half:])
            node = JobTree(kind="profile", left=left, right=right)
        # profile node: resume from a completed artifact if present
        left_names = node.left.to_list()
        right_names = node.right.to_list()
        if self.store is not None and self.store.has_node(left_names + right_names):
            self._on_task("merge-cached", "+".join(left_names + right_names))
            return self.sched.submit(
                self.store.load_node, left_names + right_names, priority=priority,
                name="load-node",
            )
        # fan out pairs NOW, overlap with subtree recursion
        pairs = [(a, b) for a in left_names for b in right_names]
        delta_futs = self._submit_pairs(pairs, priority)
        left_fut = self._process(node.left, priority + 1)
        right_fut = self._process(node.right, priority + 1)
        return spawn(
            self._merge_node,
            left_names,
            right_names,
            left_fut,
            right_fut,
            delta_futs,
            priority,
        )

    def execute(self, tree: JobTree) -> list[MafBlock]:
        try:
            return self._process(tree, priority=0).result()
        finally:
            # Join worker threads: daemon threads killed mid-device-call at
            # interpreter teardown crash the device client.
            self.sched.stop(wait=True)


def align_fastas_concurrent(
    fasta_paths: list[str],
    out_maf: str,
    cfg: PipelineConfig | None = None,
    run_size: int = 4,
    chunk_size: int = 16,
    tmp_dir: str | None = None,
    process_index: int = 0,
    process_count: int = 1,
    failover_after: float = 300.0,
) -> list[MafBlock]:
    """Concurrent version of pipeline.align_fastas.

    With ``tmp_dir``, artifacts persist for inspection/resume; with
    ``process_count > 1``, pairwise work is deterministically partitioned
    across hosts sharing ``tmp_dir``.
    """
    from paramugsy_tpu.formats.maf import MAF_HEADER, write_maf
    from paramugsy_tpu.pipeline import load_genome
    from paramugsy_tpu.runtime.artifacts import ArtifactStore, PairOwnership

    genomes = [load_genome(p) for p in fasta_paths]
    cfg = cfg or PipelineConfig()
    seq = Aligner(genomes, cfg)
    tree = seq.job_tree()
    cfg.log("job tree:\n" + tree.pp())
    store = ArtifactStore(tmp_dir) if tmp_dir else None
    ownership = (
        PairOwnership(process_index, process_count) if process_count > 1 else None
    )
    if ownership and store is None:
        raise ValueError("multi-host runs require a shared tmp_dir store")
    ex = JobExecutor(
        genomes, cfg, run_size=run_size, chunk_size=chunk_size,
        store=store, ownership=ownership, failover_after=failover_after,
    )
    from paramugsy_tpu.pipeline import finalize_blocks, gather_dup_blocks

    main_blocks = ex.execute(tree)
    # Duplication detection is per-genome work owned by process 0 (it is
    # O(genomes), tiny next to the O(genomes^2) pairwise phase).
    dups = (
        gather_dup_blocks(genomes, cfg) if process_index == 0 else []
    )
    blocks = finalize_blocks(main_blocks, dups)
    write_maf(out_maf, blocks, header=MAF_HEADER)
    return blocks
