"""End-to-end multiple alignment: FASTA list -> one MAF.

The single-process execution path (the ``paramugsy local`` role): guide tree
-> binary job tree -> recursive execution where every node is either a
degenerate single-genome leaf (fasta_to_maf role) or a profile merge fed by
on-device pairwise alignments.  Multi-genome ``mugsy`` leaves are executed
as binary merges over the guide-tree leaf order, so the whole run is one
uniform merge recursion (the reference's leaf mugsyWGA + internal profile
merges collapse into one primitive).

The distributed runtime (paramugsy_tpu.runtime) schedules these same node
computations asynchronously; this module is the sequential reference used
by tests and small runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from paramugsy_tpu.coords.range import FORWARD
from paramugsy_tpu.formats.delta import DeltaEntry
from paramugsy_tpu.formats.fasta import normalize_header, read_fasta, species_of_path
from paramugsy_tpu.formats.maf import MAF_HEADER, MafBlock, MafSequence, write_maf
from paramugsy_tpu.lcb.merge import merge_blocks
from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair
from paramugsy_tpu.ops.encode import encode
from paramugsy_tpu.tree.guide_tree import GuideTree, guide_tree_of_seqs
from paramugsy_tpu.tree.job_tree import JobTree, make_job_tree


@dataclass
class Genome:
    name: str  # species
    seqs: dict[str, str]  # normalized record name -> sequence

    @property
    def total_length(self) -> int:
        return sum(len(s) for s in self.seqs.values())

    def concat_codes(self) -> np.ndarray:
        parts = []
        for s in self.seqs.values():
            parts.append(encode(s))
            parts.append(np.array([4], dtype=np.int8))  # N separator
        return np.concatenate(parts) if parts else np.zeros(0, np.int8)


def load_genome(path: str) -> Genome:
    species = species_of_path(path)
    seqs: dict[str, str] = {}
    for header, seq in read_fasta(path):
        seqs[normalize_header(header, species)] = seq.upper()
    return Genome(name=species, seqs=seqs)


@dataclass
class PipelineConfig:
    max_seqs: int = 2  # seqs-per-mugsy; binary merge all the way by default
    min_length: int = 30  # mugsyWGA --minlength role
    emit_unique: bool = True  # False = the reference's -skipunique
    refine: bool = False  # mugsyWGA --refine role: per-block MSA polish
    refine_max_cols: int = 50_000  # skip refining blocks wider than this
    # Collinear chain/bridge gap for LCB selection (mugsyWGA --distance
    # role at merge level; lcb/merge.select_consistent + bridge_adjacent).
    chain_gap: int = 1000
    align: AlignConfig = field(default_factory=AlignConfig)
    distance_k: int = 8
    # Duplication handling (mugsy_mugsy -dup_list / mugsyWGA --duplications,
    # lib/mugsy/mugsy_mugsy.ml:125-144): detect genome-vs-self segmental
    # duplications and emit them as extra labeled blocks.
    duplications: bool = False
    dup_list: list = field(default_factory=list)  # precomputed dup MAF paths
    # Optional user-supplied guide tree (Newick); overrides the k-mer
    # sketch + UPGMA tree.  Leaf names must be genome (species) names.
    guide_tree_newick: Optional[str] = None
    progress: Optional[Callable[[str], None]] = None

    def log(self, msg: str) -> None:
        if self.progress:
            self.progress(msg)


def config_from_dict(d: dict) -> PipelineConfig:
    """Build a PipelineConfig from a plain dict (JSON config files).

    The reference injected per-cluster environment through a shell
    template file (lib/base/script_task.ml:33-61); the analog here
    is a declarative config file: top-level keys set PipelineConfig
    fields, an ``align`` object sets AlignConfig fields, and
    ``align.scoring`` the DP scores.
    """
    from paramugsy_tpu.ops.extend import Scoring

    d = dict(d)
    align_d = dict(d.pop("align", {}))
    scoring_d = align_d.pop("scoring", None)
    align = AlignConfig(**align_d)
    if scoring_d:
        align.scoring = Scoring(**scoring_d)
    known = {f for f in PipelineConfig.__dataclass_fields__ if f not in ("align", "progress")}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return PipelineConfig(align=align, **d)


def load_config(path: str) -> PipelineConfig:
    import json

    with open(path) as f:
        return config_from_dict(json.load(f))


def genome_pair_deltas(
    a: Genome, b: Genome, cfg: AlignConfig, device_cache: dict | None = None
) -> list[DeltaEntry]:
    """All-contig-pairs pairwise alignment of two genomes (nucmer role)."""
    out: list[DeltaEntry] = []
    for ra_name, ra in a.seqs.items():
        for rb_name, rb in b.seqs.items():
            out.extend(
                align_pair(ra, rb, ra_name, rb_name, cfg, device_cache)
            )
    return out


def genome_pair_deltas_batch(
    genome_pairs: list[tuple[Genome, Genome]],
    cfg: AlignConfig,
    device_cache: dict | None = None,
) -> list[list[DeltaEntry]]:
    """Deltas for a CHUNK of genome pairs in one device dispatch.

    All contig-level jobs across the chunk batch through
    `ops.align_pair.align_pairs_batch` — one vmapped kernel launch and
    one packed transfer per bucket group, the device analog of the
    reference's chunked nucmer fan-out (lib/base/job_processor.ml:128-154).
    """
    from paramugsy_tpu.ops.align_pair import align_pairs_batch

    jobs: list[tuple] = []
    owners: list[int] = []
    for t, (a, b) in enumerate(genome_pairs):
        for ra_name, ra in a.seqs.items():
            for rb_name, rb in b.seqs.items():
                jobs.append((ra, rb, ra_name, rb_name))
                owners.append(t)
    per_job = align_pairs_batch(jobs, cfg, device_cache)
    out: list[list[DeltaEntry]] = [[] for _ in genome_pairs]
    for t, entries in zip(owners, per_job):
        out[t].extend(entries)
    return out


def fake_mugsy_blocks(g: Genome) -> list[MafBlock]:
    """Single-genome degenerate leaf (lib/profiles/m_maf.ml role)."""
    return [
        MafBlock(
            seqs=[
                MafSequence(
                    name=name, start=0, size=len(seq), strand=FORWARD,
                    src_size=len(seq), text=seq,
                )
            ],
            score=len(seq),
            attrs={"label": "1", "mult": "1"},
        )
        for name, seq in g.seqs.items()
    ]


class Aligner:
    """Executes the job tree sequentially in one process.

    ``delta_pool``: precomputed pairwise delta entries (e.g. converted from
    the reference's -maf_list pairwise MAFs, lib/mugsy/mugsy_mugsy.ml:37-48).
    Pairs covered by the pool are not recomputed; uncovered pairs are
    aligned on device.
    """

    def __init__(
        self,
        genomes: list[Genome],
        cfg: PipelineConfig | None = None,
        delta_pool: list[DeltaEntry] | None = None,
    ):
        self.cfg = cfg or PipelineConfig()
        self.genomes = {g.name: g for g in genomes}
        self._uid = 0
        # Device-resident padded genome codes, shared across all pairs of
        # the run (contig name + length -> device array).
        self._device_cache: dict = {}
        # Pool index: (ref genome, query genome) -> entries.
        self._pool: dict = {}
        if delta_pool:
            contig_genome = {
                contig: g.name
                for g in genomes
                for contig in g.seqs
            }
            for e in delta_pool:
                ga = contig_genome.get(e.ref_name)
                gb = contig_genome.get(e.query_name)
                if ga is None or gb is None or ga == gb:
                    continue
                self._pool.setdefault((ga, gb), []).append(e)

    def _next_uid(self) -> str:
        self._uid += 1
        return f"n{self._uid:04d}"

    def guide_tree(self) -> GuideTree:
        from paramugsy_tpu.utils.obs import METRICS

        if self.cfg.guide_tree_newick:
            from paramugsy_tpu.tree.guide_tree import parse_newick

            tree = parse_newick(self.cfg.guide_tree_newick)
            leaves = set(tree.leaves())
            missing = set(self.genomes) - leaves
            extra = leaves - set(self.genomes)
            if missing or extra:
                raise ValueError(
                    f"guide tree/genome mismatch: missing={sorted(missing)} "
                    f"extra={sorted(extra)}"
                )
            return tree
        with METRICS.phase("guide_tree", items=len(self.genomes)):
            names = list(self.genomes)
            codes = [self.genomes[n].concat_codes() for n in names]
            return guide_tree_of_seqs(codes, names, k=self.cfg.distance_k)

    def job_tree(self) -> JobTree:
        order = self.guide_tree().leaves()
        return make_job_tree(order, max(self.cfg.max_seqs, 2))

    def merge_lists(
        self, left: list[str], right: list[str],
        left_blocks: list[MafBlock], right_blocks: list[MafBlock],
    ) -> list[MafBlock]:
        from paramugsy_tpu.utils.obs import METRICS

        deltas: list[DeltaEntry] = []
        with METRICS.phase("pairwise", items=len(left) * len(right)):
            for a in left:
                for b in right:
                    if (a, b) in self._pool:
                        deltas.extend(self._pool[a, b])
                    elif (b, a) in self._pool:
                        deltas.extend(e.swapped() for e in self._pool[b, a])
                    else:
                        self.cfg.log(f"pairwise {a} vs {b}")
                        deltas.extend(
                            genome_pair_deltas(
                                self.genomes[a], self.genomes[b], self.cfg.align,
                                self._device_cache,
                            )
                        )
        uid = self._next_uid()
        self.cfg.log(f"merge {len(left)}+{len(right)} genomes ({uid})")
        return merge_blocks(
            left_blocks,
            right_blocks,
            deltas,
            basename_left=f"l{uid}",
            basename_right=f"r{uid}",
            min_length=self.cfg.min_length,
            emit_unique=self.cfg.emit_unique,
            refine=self.cfg.refine,
            refine_max_cols=self.cfg.refine_max_cols,
            chain_gap=self.cfg.chain_gap,
        )

    def align_ordered(self, order: list[str]) -> list[MafBlock]:
        """Binary merge over an ordered genome list."""
        if len(order) == 1:
            return fake_mugsy_blocks(self.genomes[order[0]])
        half = len(order) // 2
        left, right = order[:half], order[half:]
        lb = self.align_ordered(left)
        rb = self.align_ordered(right)
        return self.merge_lists(left, right, lb, rb)

    def run_node(self, node: JobTree) -> list[MafBlock]:
        if node.kind == "fake_mugsy":
            return fake_mugsy_blocks(self.genomes[node.genomes[0]])
        if node.kind == "mugsy":
            return self.align_ordered(node.genomes)
        lb = self.run_node(node.left)
        rb = self.run_node(node.right)
        return self.merge_lists(node.left.to_list(), node.right.to_list(), lb, rb)

    def run(self) -> list[MafBlock]:
        tree = self.job_tree()
        self.cfg.log("job tree:\n" + tree.pp())
        return self.run_node(tree)


def duplication_blocks(
    genomes: list[Genome], cfg: PipelineConfig
) -> list[MafBlock]:
    """Per-genome self-alignment -> duplication MAF blocks (label=dup*).

    The mugsyWGA --duplications role: each block pairs two copies of a
    segmental duplication within one genome (second row reverse-strand for
    inverted repeats).
    """
    from paramugsy_tpu.formats.delta_maf import delta_to_maf_blocks
    from paramugsy_tpu.ops.align_pair import align_self

    out: list[MafBlock] = []
    for g in genomes:
        for name, seq in g.seqs.items():
            cfg.log(f"duplications {name}")
            entries = [
                e
                for e in align_self(seq, name, cfg.align)
                if e.alignment_length() >= cfg.min_length
            ]
            out.extend(delta_to_maf_blocks(entries, g.seqs, g.seqs))
    for b in out:
        b.attrs["label"] = "dup"
    return out


def gather_dup_blocks(
    genomes: list[Genome], cfg: PipelineConfig
) -> list[MafBlock]:
    """Duplication blocks from self-alignment and/or precomputed MAFs
    (the -dup_list file-list form of mugsy_mugsy)."""
    from paramugsy_tpu.formats.maf import read_maf

    dups: list[MafBlock] = []
    if cfg.duplications:
        dups.extend(duplication_blocks(genomes, cfg))
    for path in cfg.dup_list:
        for b in read_maf(path):
            b.attrs["label"] = "dup"
            dups.append(b)
    return dups


def finalize_blocks(
    blocks: list[MafBlock], dup_blocks: list[MafBlock] = ()
) -> list[MafBlock]:
    """Assign sequential LCB labels (the reference's ``label=`` ids) and
    sum-of-pairs alignment scores (the mugsyWGA score role, cf.
    lib/profiles/m_untranslate.ml:219 — NOT row length; see lcb/score.py);
    duplication blocks follow with ``dup<N>`` labels."""
    from paramugsy_tpu.lcb.score import score_blocks

    for i, b in enumerate(blocks):
        b.attrs["label"] = str(i + 1)
        b.attrs["mult"] = str(len(b.seqs))
    for i, b in enumerate(dup_blocks):
        b.attrs["label"] = f"dup{i + 1}"
        b.attrs["mult"] = str(len(b.seqs))
    out = list(blocks) + list(dup_blocks)
    score_blocks(out)
    return out


def align_fastas(
    fasta_paths: list[str], out_maf: str, cfg: PipelineConfig | None = None
) -> list[MafBlock]:
    """CLI-level entry: FASTA files -> MAF file."""
    genomes = [load_genome(p) for p in fasta_paths]
    aligner = Aligner(genomes, cfg)
    blocks = finalize_blocks(
        aligner.run(), gather_dup_blocks(genomes, aligner.cfg)
    )
    write_maf(out_maf, blocks, header=MAF_HEADER)
    return blocks
