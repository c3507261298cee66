"""Command-line entry (the paramugsy + worker-binaries CLI surface).

Subcommands mirror the reference's executables:

    align / local      paramugsy local run (lib/base/paramugsy.ml:232-248)
    nucmer             one pairwise comparison (lib/nucmer/mugsy_nucmer.ml)
    profiles make|translate|untranslate|maf_to_xmfa|fasta_to_maf
                       (lib/profiles/m_profiles_cli.ml:6-21)
    mafstat mafvalidate mafclean fastafmt mafdefrag maffiller analyzer
    sortdelta          (the aux MAF toolchain)
"""
from __future__ import annotations

import sys


def _align_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="paramugsy-tpu align")
    ap.add_argument("-seq_list", help="file listing genome FASTA paths")
    ap.add_argument("fastas", nargs="*", help="genome FASTA paths")
    ap.add_argument("-out_maf", required=True)
    ap.add_argument("-seqs_per_mugsy", type=int, default=2)
    ap.add_argument("-minlength", type=int, default=30)
    ap.add_argument(
        "-distance", type=int, default=200,
        help="max distance between joined anchor clusters (mugsyWGA --distance role)",
    )
    ap.add_argument(
        "-skipunique", action="store_true",
        help="do not emit unaligned (unique) regions in the output MAF",
    )
    ap.add_argument(
        "-refine", nargs="?", const="colinear", default=None,
        help="per-block MSA refinement after each merge "
        "(mugsyWGA --refine role); optional value is accepted for "
        "reference-CLI compatibility",
    )
    ap.add_argument(
        "-duplications", action="store_true",
        help="detect per-genome segmental duplications (genome-vs-self "
        "repeat alignment) and append them as label=dup* blocks "
        "(mugsyWGA --duplications role)",
    )
    ap.add_argument(
        "-dup_list",
        help="file listing precomputed duplication MAF paths to append "
        "(mugsy_mugsy -dup_list role)",
    )
    ap.add_argument("-run_size", type=int, default=4, help="concurrent task slots")
    ap.add_argument("-nucmer_chunk_size", type=int, default=16)
    ap.add_argument("-sequential", action="store_true", help="single-threaded run")
    ap.add_argument(
        "-tmp_dir", help="artifact store: per-node/pair outputs, enables resume"
    )
    ap.add_argument(
        "-distributed",
        action="store_true",
        help="join the jax.distributed world (JAX_COORDINATOR_ADDRESS, "
        "JAX_NUM_PROCESSES, JAX_PROCESS_ID); pairs partition across "
        "processes sharing -tmp_dir, one card each on a shared host",
    )
    ap.add_argument(
        "-tree", help="Newick guide-tree file (leaf names = genome names); "
        "overrides the built-in sketch+UPGMA tree",
    )
    ap.add_argument("-config", help="JSON config file (PipelineConfig fields)")
    ap.add_argument(
        "-stats", action="store_true",
        help="print phase timings and peak RSS at the end",
    )
    ap.add_argument(
        "-trace",
        help="write a Chrome trace-event JSON of all phases (open in "
        "chrome://tracing or Perfetto)",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.trace:
        from paramugsy_tpu.utils.obs import TRACE

        TRACE.enable()

    paths = list(args.fastas)
    if args.seq_list:
        with open(args.seq_list) as f:
            paths.extend(l.strip() for l in f if l.strip())
    if not paths:
        ap.error("no input genomes (use -seq_list or positional FASTA paths)")

    from paramugsy_tpu.ops.align_pair import AlignConfig
    from paramugsy_tpu.pipeline import PipelineConfig, load_config

    if args.config:
        cfg = load_config(args.config)
    else:
        cfg = PipelineConfig(
            max_seqs=args.seqs_per_mugsy,
            min_length=args.minlength,
            emit_unique=not args.skipunique,
            refine=args.refine is not None,
            align=AlignConfig(break_len=args.distance),
        )
    if args.tree:
        with open(args.tree) as f:
            cfg.guide_tree_newick = f.read().strip()
    if args.duplications:
        cfg.duplications = True
    if args.dup_list:
        with open(args.dup_list) as f:
            cfg.dup_list = [l.strip() for l in f if l.strip()]
    cfg.progress = (lambda m: print(m, file=sys.stderr)) if args.verbose else None
    if args.sequential:
        from paramugsy_tpu.pipeline import align_fastas

        blocks = align_fastas(paths, args.out_maf, cfg)
    else:
        from paramugsy_tpu.runtime.executor import align_fastas_concurrent

        process_index, process_count = 0, 1
        if args.distributed:
            from paramugsy_tpu.runtime.dist import init_distributed

            ctx = init_distributed()
            process_index, process_count = ctx.process_index, ctx.process_count
        blocks = align_fastas_concurrent(
            paths, args.out_maf, cfg,
            run_size=args.run_size, chunk_size=args.nucmer_chunk_size,
            tmp_dir=args.tmp_dir,
            process_index=process_index, process_count=process_count,
        )
    print(f"wrote {args.out_maf}: {len(blocks)} blocks", file=sys.stderr)
    if args.trace:
        from paramugsy_tpu.utils.obs import TRACE

        TRACE.save(args.trace)
        print(f"trace written to {args.trace}", file=sys.stderr)
    if args.stats:
        from paramugsy_tpu.utils.obs import METRICS, MemoryMonitor

        print(METRICS.report(), file=sys.stderr)
        print(f"peak_rss_kb\t{MemoryMonitor._rss_kb()}", file=sys.stderr)
    return 0


def _nucmer_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="paramugsy-tpu nucmer")
    ap.add_argument("-ref_seq", required=True)
    ap.add_argument("-query_seq", required=True)
    ap.add_argument("-out_delta")
    ap.add_argument("-out_maf")
    ap.add_argument("-minlength", type=int, default=20)
    ap.add_argument("-one_to_one", action="store_true", help="delta-filter -1 role")
    ap.add_argument(
        "-colinear", action="store_true",
        help="keep a single colinear chain (delta-filter -m role)",
    )
    args = ap.parse_args(argv)

    from paramugsy_tpu.formats.delta import DeltaWriter
    from paramugsy_tpu.formats.delta_maf import delta_to_maf_blocks
    from paramugsy_tpu.formats.maf import write_maf
    from paramugsy_tpu.ops.align_pair import (
        AlignConfig,
        align_pair,
        filter_colinear,
        filter_one_to_one,
    )
    from paramugsy_tpu.pipeline import load_genome

    ref = load_genome(args.ref_seq)
    query = load_genome(args.query_seq)
    cfg = AlignConfig(min_match=args.minlength)
    entries = []
    for rn, rs in ref.seqs.items():
        for qn, qs in query.seqs.items():
            entries.extend(align_pair(rs, qs, rn, qn, cfg))
    if args.colinear:
        entries = filter_colinear(entries)
    elif args.one_to_one:
        entries = filter_one_to_one(entries)
    if args.out_delta:
        with open(args.out_delta, "w") as f:
            w = DeltaWriter(f, args.ref_seq, args.query_seq)
            for e in entries:
                w.write(e)
    if args.out_maf:
        ref_seqs = dict(ref.seqs)
        query_seqs = dict(query.seqs)
        write_maf(
            args.out_maf, delta_to_maf_blocks(entries, ref_seqs, query_seqs)
        )
    print(f"{len(entries)} alignments", file=sys.stderr)
    return 0


def _sge_main(argv: list[str]) -> int:
    """The reference's ``paramugsy sge`` mode (lib/base/paramugsy.ml:232-248).

    Cluster scheduling + rsync staging are superseded by jax.distributed +
    a shared artifact store: this maps to ``align -distributed`` and warns
    about SGE-only flags it absorbs (-template_file, -exec_q, -data_q).
    """
    passthrough: list[str] = []
    skip_next = False
    absorbed = []
    for a in argv:
        if skip_next:
            skip_next = False
            continue
        if a in ("-template_file", "-template-file", "-exec_q", "-exec-q",
                 "-data_q", "-data-q"):
            absorbed.append(a)
            skip_next = True
            continue
        passthrough.append(a)
    if absorbed:
        print(
            f"sge: flags {absorbed} are superseded by jax.distributed + "
            "the shared -tmp_dir artifact store; ignoring",
            file=sys.stderr,
        )
    if "-distributed" not in passthrough:
        passthrough.append("-distributed")
    return _align_main(passthrough)


def _mugsy_main(argv: list[str]) -> int:
    """The mugsy_mugsy worker role (lib/mugsy/mugsy_mugsy.ml): one
    multi-genome LCB call over precomputed pairwise MAFs."""
    import argparse

    ap = argparse.ArgumentParser(prog="paramugsy-tpu mugsy")
    ap.add_argument("-out_dir", required=True)
    ap.add_argument("-basename", default="mugsy")
    ap.add_argument("-seq_list", required=True, help="file listing genome FASTAs")
    ap.add_argument(
        "-maf_list", help="file listing pairwise MAF paths (pairs not "
        "covered are aligned on device)"
    )
    ap.add_argument("-minlength", type=int, default=30)
    ap.add_argument("-distance", type=int, default=200)
    ap.add_argument("-colinear", action="store_true", help="refine colinear role")
    ap.add_argument("-skipunique", action="store_true")
    ap.add_argument("-dup_list", help="file listing duplication MAF paths")
    args = ap.parse_args(argv)

    import os

    from paramugsy_tpu.formats.delta_maf import maf_blocks_to_deltas
    from paramugsy_tpu.formats.maf import MAF_HEADER, read_maf, write_maf
    from paramugsy_tpu.ops.align_pair import AlignConfig
    from paramugsy_tpu.pipeline import (
        Aligner,
        PipelineConfig,
        finalize_blocks,
        gather_dup_blocks,
        load_genome,
    )

    def read_list(path):
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]

    genomes = [load_genome(p) for p in read_list(args.seq_list)]
    pool = []
    for maf in read_list(args.maf_list) if args.maf_list else []:
        pool.extend(maf_blocks_to_deltas(read_maf(maf)))
    cfg = PipelineConfig(
        min_length=args.minlength,
        emit_unique=not args.skipunique,
        refine=args.colinear,
        dup_list=read_list(args.dup_list) if args.dup_list else [],
        align=AlignConfig(break_len=args.distance),
    )
    aligner = Aligner(genomes, cfg, delta_pool=pool)
    blocks = finalize_blocks(aligner.run(), gather_dup_blocks(genomes, cfg))
    os.makedirs(args.out_dir, exist_ok=True)
    out_maf = os.path.join(args.out_dir, f"{args.basename}.maf")
    write_maf(out_maf, blocks, header=MAF_HEADER)
    print(out_maf)  # the reference prints the produced MAF path
    return 0


def _repeats_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="paramugsy-tpu repeats")
    ap.add_argument("-seq", required=True, help="genome FASTA")
    ap.add_argument("-out_maf")
    ap.add_argument("-out_delta")
    ap.add_argument("-minlength", type=int, default=65)
    args = ap.parse_args(argv)

    from paramugsy_tpu.formats.delta import DeltaWriter
    from paramugsy_tpu.formats.delta_maf import delta_to_maf_blocks
    from paramugsy_tpu.formats.maf import write_maf
    from paramugsy_tpu.ops.align_pair import AlignConfig, align_self
    from paramugsy_tpu.pipeline import load_genome

    g = load_genome(args.seq)
    entries = []
    for name, seq in g.seqs.items():
        entries.extend(
            e
            for e in align_self(seq, name, AlignConfig())
            if e.alignment_length() >= args.minlength
        )
    if args.out_delta:
        with open(args.out_delta, "w") as f:
            w = DeltaWriter(f, args.seq, args.seq)
            for e in entries:
                w.write(e)
    if args.out_maf:
        write_maf(args.out_maf, delta_to_maf_blocks(entries, g.seqs, g.seqs))
    print(f"{len(entries)} repeat alignments", file=sys.stderr)
    return 0


def _profiles_main(argv: list[str]) -> int:
    import argparse

    if not argv:
        print(
            "usage: paramugsy-tpu profiles {make,translate,untranslate,"
            "maf_to_xmfa,fasta_to_maf} ...",
            file=sys.stderr,
        )
        return 2
    sub, rest = argv[0], argv[1:]
    ap = argparse.ArgumentParser(prog=f"paramugsy-tpu profiles {sub}")
    if sub == "make":
        ap.add_argument("-basename", required=True)
        ap.add_argument("-out_dir", required=True)
        ap.add_argument("-in_maf", required=True)
        a = ap.parse_args(rest)
        from paramugsy_tpu.profiles.make import profile_set_of_maf

        profile_set_of_maf(a.in_maf, a.out_dir, a.basename)
        return 0
    if sub == "translate":
        ap.add_argument("left_dir")
        ap.add_argument("right_dir")
        ap.add_argument("-nucmer_list", required=True)
        ap.add_argument("-out_delta", required=True)
        a = ap.parse_args(rest)
        from paramugsy_tpu.profiles.translate import translate

        with open(a.nucmer_list) as f:
            nucmers = [l.strip() for l in f if l.strip()]
        with open(a.out_delta, "w") as out:
            translate(a.left_dir, a.right_dir, nucmers, out)
        return 0
    if sub == "untranslate":
        ap.add_argument("-profile_paths_list", required=True)
        ap.add_argument("-in_maf", required=True)
        ap.add_argument("-out_maf", required=True)
        a = ap.parse_args(rest)
        from paramugsy_tpu.formats.maf import MAF_HEADER, write_maf
        from paramugsy_tpu.profiles.untranslate import untranslate

        with open(a.profile_paths_list) as f:
            dirs = [l.strip() for l in f if l.strip()]
        blocks = list(untranslate(dirs, a.in_maf))
        write_maf(a.out_maf, blocks, header=MAF_HEADER)
        return 0
    if sub == "maf_to_xmfa":
        ap.add_argument("-in_maf", required=True)
        a = ap.parse_args(rest)
        from paramugsy_tpu.formats.maf import maf_to_xmfa

        maf_to_xmfa(a.in_maf, sys.stdout)
        return 0
    if sub == "fasta_to_maf":
        ap.add_argument("-in_fasta", required=True)
        ap.add_argument("-out_maf", required=True)
        a = ap.parse_args(rest)
        from paramugsy_tpu.formats.maf import fasta_to_maf

        with open(a.out_maf, "w") as f:
            fasta_to_maf(a.in_fasta, f)
        return 0
    print(f"unknown profiles subcommand: {sub}", file=sys.stderr)
    return 2


_DEVICE_COMMANDS = {"align", "local", "sge", "nucmer", "repeats", "mugsy"}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _DEVICE_COMMANDS:
        # No fallback: JAX raises when the requested platform is absent.
        import jax

        from paramugsy_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        if "-distributed" in argv or argv[0] == "sge":
            # Joins the process world before anything opens a device.
            from paramugsy_tpu.runtime.dist import init_distributed

            init_distributed()
        dev = jax.local_devices()[0]
        print(
            f"device: {dev.platform} {dev.device_kind} x{jax.local_device_count()}"
            f" (process {jax.process_index()} of {jax.process_count()})",
            file=sys.stderr,
        )
    if not argv:
        print(
            "usage: paramugsy-tpu {align|local|nucmer|mugsy|repeats|profiles|mafstat|"
            "mafvalidate|mafclean|fastafmt|mafdefrag|maffiller|analyzer|"
            "sortdelta} ...",
            file=sys.stderr,
        )
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd in ("align", "local"):
        return _align_main(rest)
    if cmd == "sge":
        return _sge_main(rest)
    if cmd == "nucmer":
        return _nucmer_main(rest)
    if cmd == "repeats":
        return _repeats_main(rest)
    if cmd == "mugsy":
        return _mugsy_main(rest)
    if cmd == "profiles":
        return _profiles_main(rest)
    if cmd == "mafstat":
        from paramugsy_tpu.tools.mafstat import main as m

        return m(rest)
    if cmd == "mafvalidate":
        from paramugsy_tpu.tools.mafvalidate import main as m

        return m(rest)
    if cmd in ("mafdefrag", "stitch"):
        from paramugsy_tpu.tools.stitch import main as m

        return m(rest)
    if cmd == "maffiller":
        from paramugsy_tpu.tools.maffiller import main as m

        return m(rest)
    if cmd == "analyzer":
        from paramugsy_tpu.tools.maf_analyzer import main as m

        return m(rest)
    if cmd == "mafclean":
        from paramugsy_tpu.tools.misc import mafclean_main as m

        return m(rest)
    if cmd == "fastafmt":
        from paramugsy_tpu.tools.misc import fastafmt_main as m

        return m(rest)
    if cmd == "sortdelta":
        from paramugsy_tpu.tools.misc import sort_delta_main as m

        return m(rest)
    print(f"unknown command: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
