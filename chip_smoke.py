#!/usr/bin/env python3
"""Bring-up smoke of the aligner on one NVIDIA GPU.

Runs the main path through the entry points a user calls, at the sizes of
BASELINE.json configs 2 and 3, checks every result against the repo's own
references, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

All inputs are generated from --seed; nothing is downloaded.  Phases:

  gpu-tests  the tests marked `gpu`, in a child process, on the card;
  pair       `cli nucmer` on two 4,641,652 bp genomes (1% substitutions,
             indels, one inversion; longer than AlignConfig.window, so the
             windowed path runs);
  multi      `cli align` on four ~2.0 Mbp genomes (1% substitutions,
             indels, one inversion, a 40 x 4 kb repeat family), the
             concurrent executor path;
  cpu-check  both commands again in children held to the CPU; the delta
             file, the MAF rows and their statistics must be equal, and
             both MAFs free of mafvalidate faults;
  seeding    the fused seeding dispatch on a 2 Mbp pair, GPU vs CPU, and
             find_seeds on a 256 kb pair vs the brute-force reference;
  tree       the guide tree's sketch intersections S @ S.T on the GPU vs
             NumPy, exactly;
  dp         the device wavefront vs the host C++ banded engine on
             64 pairs x 16 kb, band 512, pair for pair.

With --four-gpus it runs only the four-GPU paths over eight ~2 Mbp genomes:
`cli align -distributed` as four processes, one card each, and
align_fastas_sharded on a 4-GPU `pairs` mesh, both against the sequential
Aligner, row for row; and the kdim-sharded distance step against the
one-card intersection_matrix.  Its last line has count 4.

Any failed phase ends the run with a non-zero exit and no result line, as
does a machine without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PAIR_BP = 4_641_652  # E. coli K-12 MG1655 (BASELINE config 2)
FAMILY_BP = 2_000_000  # Streptococcus-sized genomes (BASELINE config 3)
SEEDING_BP = 2_000_000
FIND_SEEDS_BP = 256_000
BASES = np.frombuffer(b"ACGT", np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def write_fasta(path: str, name: str, codes: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(f">{name}.chr\n".encode())
        f.write(BASES[codes].tobytes())
        f.write(b"\n")
    return path


def write_family(work: str, genomes: list[np.ndarray], tag: str) -> list[str]:
    return [
        write_fasta(os.path.join(work, f"{tag}{i}.fa"), f"{tag}{i}", g)
        for i, g in enumerate(genomes)
    ]


def cli_args(paths: dict, side: str) -> dict:
    """The two user commands, writing outputs with a per-side suffix."""
    out = paths["work"]
    return {
        "pair": [
            "nucmer", "-ref_seq", paths["ref"], "-query_seq", paths["qry"],
            "-out_delta", f"{out}/pair_{side}.delta",
            "-out_maf", f"{out}/pair_{side}.maf",
        ],
        "multi": ["align", *paths["family"], "-out_maf", f"{out}/multi_{side}.maf"],
    }


def start_cli(work: str, name: str, args: list[str], env: dict):
    """A user command in a child process, its output in <work>/<name>.log."""
    logf = open(os.path.join(work, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paramugsy_tpu.cli", *args],
        cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT,
    )
    return name, proc, logf


def start_cpu_reference(paths: dict) -> list:
    """Both commands in children held to the CPU: they never open the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return [
        start_cli(paths["work"], f"{name}_cpu", args, env)
        for name, args in cli_args(paths, "cpu").items()
    ]


def kill_children(procs: list) -> None:
    for _, p, logf in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()


def wait_children(procs: list) -> list[str]:
    """Wait for every child; their logs, or an error naming the first
    that failed.  Children still running when this raises are killed."""
    logs = []
    try:
        for name, p, logf in procs:
            rc = p.wait(timeout=900)
            logf.close()
            with open(logf.name) as f:
                logs.append(f.read())
            if rc != 0:
                raise RuntimeError(f"child {name} exited {rc}:\n{logs[-1][-3000:]}")
    finally:
        kill_children(procs)
    return logs


def start_distributed_cli(work: str, paths: list[str], n: int) -> list:
    """`cli align -distributed` as n processes on this host, configured
    through the environment as a user would; each takes one card."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return [
        start_cli(
            work, f"dist{i}",
            ["align", *paths, "-out_maf", os.path.join(work, f"dist{i}.maf"),
             "-tmp_dir", os.path.join(work, "store"), "-distributed"],
            dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                 JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(i)),
        )
        for i in range(n)
    ]


def run_gpu_tests(work: str) -> None:
    """The tests marked `gpu`, in a child, before this process opens the card."""
    xml = os.path.join(work, "gpu_tests.xml")
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    counts = {k: int(suite.get(k)) for k in ("tests", "failures", "errors", "skipped")}
    log(f"gpu-tests: {counts} wall {time.perf_counter() - t0:.3f} s")
    if r.returncode != 0 or counts["tests"] == 0 or (
        counts["failures"] + counts["errors"] + counts["skipped"]
    ):
        raise RuntimeError(f"gpu tests failed:\n{r.stdout[-4000:]}{r.stderr[-2000:]}")


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(
            f"needs {n} GPU(s); JAX found {len(devs)} {devs[0].platform} device(s)"
        )
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    return devs


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def counts_since(before: dict) -> dict:
    from paramugsy_tpu.ops import engines

    return {
        k: v - before.get(k, 0)
        for k, v in engines.COUNTS.items()
        if v - before.get(k, 0)
    }


def cli_phase(name: str, args: list[str], warm_args: list[str], dev) -> dict:
    """A user command twice: the first run compiles, the second is timed
    warm.  The CLI returns after its outputs are written, which ends the
    timed window."""
    from paramugsy_tpu import cli
    from paramugsy_tpu.ops import engines

    t0 = time.perf_counter()
    if cli.main(args) != 0:
        raise RuntimeError(f"{name}: cli {args[0]} failed")
    cold = time.perf_counter() - t0
    before = dict(engines.COUNTS)
    t0 = time.perf_counter()
    if cli.main(warm_args) != 0:
        raise RuntimeError(f"{name}: cli {args[0]} failed")
    warm = time.perf_counter() - t0
    res = {
        "compile_s": cold - warm,
        "cold_s": cold,
        "warm_s": warm,
        "peak_bytes_in_use": peak_bytes(dev),
        "engines": counts_since(before),
    }
    log(f"{name}: {json.dumps(res)}")
    return res


def maf_rows(path: str) -> list[str]:
    with open(path) as f:
        return [line for line in f if line.startswith("s ")]


def check_outputs(paths: dict) -> dict:
    """GPU outputs against the CPU run of the same commands."""
    from paramugsy_tpu.formats.delta import read_delta
    from paramugsy_tpu.tools.mafstat import compute_stats
    from paramugsy_tpu.tools.mafvalidate import find_faults

    w = paths["work"]
    out = {}
    for side in ("gpu", "cpu"):
        with open(f"{w}/pair_{side}.delta") as f:
            entries = list(read_delta(f))
        st = compute_stats(f"{w}/multi_{side}.maf")
        pair_faults = find_faults(f"{w}/pair_{side}.maf")
        out[side] = {
            "pair_entries": len(entries),
            "pair_aligned_bp": sum(e.alignment_length() for e in entries),
            "pair_maf_faults": [str(f) for f in pair_faults],
            "multi_core_bp": st.core_bp,
            "multi_sp_identity": st.sp_identity,
            "multi_maf_faults": len(find_faults(f"{w}/multi_{side}.maf")),
        }
    with open(f"{w}/pair_gpu.delta") as a, open(f"{w}/pair_cpu.delta") as b:
        out["pair_delta_identical"] = a.read() == b.read()
    for name in ("pair", "multi"):
        out[f"{name}_maf_rows_identical"] = maf_rows(f"{w}/{name}_gpu.maf") == maf_rows(
            f"{w}/{name}_cpu.maf"
        )
    log(f"cpu-check: {json.dumps(out)}")
    g, c = out["gpu"], out["cpu"]
    if g["multi_maf_faults"] or g["pair_maf_faults"]:
        raise AssertionError(f"mafvalidate faults in the GPU MAFs: {g['pair_maf_faults'][:5]}")
    # The seeding output is equal on both platforms (phase seeding) and
    # everything after it runs on the host, so the files must be equal.
    same = ("pair_delta_identical", "pair_maf_rows_identical", "multi_maf_rows_identical")
    if not all(out[k] for k in same) or g != c:
        raise AssertionError("GPU and CPU runs of the same command differ")
    return out


def canonical_seed_clusters(packed, max_seeds: int, max_clusters: int):
    """What the seeding dispatch guarantees independent of tie order: the
    valid seeds and valid cluster summaries of each strand, as sets."""
    from paramugsy_tpu.ops.seeding import unpack_seed_clusters

    _, n_runs, samp_over, _, strands = unpack_seed_clusters(
        packed, max_seeds, max_clusters
    )
    out = [n_runs, samp_over]
    for s in strands:
        nv, nc = s.n_valid, s.n_clusters
        seeds = sorted(zip(*(x[:nv].tolist() for x in (s.seed_rpos, s.seed_qpos, s.seed_len))))
        keep = s.c_mask[:nc]
        summ = sorted(
            zip(*(x[:nc][keep].tolist() for x in (
                s.c_rstart, s.c_rend, s.c_qstart, s.c_qend, s.c_weight, s.c_nseeds
            )))
        )
        out.append((nv, nc, seeds, summ))
    return out


def phase_seeding(seed: int, dev) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from paramugsy_tpu.ops import align_pair as ap
    from paramugsy_tpu.ops.encode import bucket_size, decode, pad_to
    from paramugsy_tpu.ops.seeding import find_seeds, seed_cluster_both_packed
    from tests.test_ops import brute_unique_matches

    ref, q = bench.build_pair(np.random.default_rng(seed + 2), SEEDING_BP)
    cfg = ap.AlignConfig()
    nr, nq = bucket_size(len(ref)), bucket_size(len(q))
    ms = ap.initial_max_seeds(cfg, nr, nq)
    shift = ap.resolve_sample_shift(cfg, nr, nq)
    m_out, c_out = ap.transfer_slice(cfg, shift, ms)

    def dispatch(d):
        r = jax.device_put(pad_to(ref, nr), d)
        qq = jax.device_put(pad_to(q, nq), d)
        t0 = time.perf_counter()
        out = seed_cluster_both_packed(
            r, qq, None, jax.device_put(jnp.int32(len(q)), d),
            k=cfg.k, max_seeds=ms, min_match=cfg.min_match, band=cfg.band,
            max_gap=cfg.max_gap, max_clusters=cfg.max_clusters,
            sample_shift=shift, m_out=m_out, c_out=c_out,
        ).block_until_ready()
        return np.asarray(out), time.perf_counter() - t0

    gpu, cold = dispatch(dev)
    gpu, warm = dispatch(dev)
    cpu, _ = dispatch(jax.devices("cpu")[0])
    exact = bool(np.array_equal(gpu, cpu))
    same_set = canonical_seed_clusters(gpu, ms, cfg.max_clusters) == (
        canonical_seed_clusters(cpu, ms, cfg.max_clusters)
    )

    rng = np.random.default_rng(seed + 3)
    r256 = rng.integers(0, 4, size=FIND_SEEDS_BP).astype(np.int8)
    q256 = bench.mutate(rng, r256, 0.01)
    k, cap = 16, 1 << 16
    out = find_seeds(jax.device_put(r256, dev), jax.device_put(q256, dev), k=k, max_seeds=cap)
    if int(out.n_runs) > cap:
        raise AssertionError(f"find_seeds bucket overflow: {int(out.n_runs)} runs")
    m = np.asarray(out.mask)
    got = set()
    for r, qp, ln in zip(np.asarray(out.rpos)[m], np.asarray(out.qpos)[m], np.asarray(out.length)[m]):
        got.update((int(r) + o, int(qp) + o) for o in range(int(ln) - k + 1))
    want = brute_unique_matches(decode(r256), decode(q256), k)
    res = {
        "dispatch_compile_s": cold - warm,
        "dispatch_warm_s": warm,
        "packed_exact_vs_cpu": exact,
        "seed_set_equal_vs_cpu": same_set,
        "find_seeds_matches": len(want),
        "find_seeds_equal_brute": got == want,
        "peak_bytes_in_use": peak_bytes(dev),
    }
    log(f"seeding: {json.dumps(res)}")
    # Integers, tolerance 0.  seed_set_equal_vs_cpu (tie order ignored)
    # only explains a failure: no platform difference in tie order is
    # known, so none is allowed.
    if not exact or got != want:
        raise AssertionError("seeding differs from its reference")
    return res


def phase_tree(family: list[np.ndarray], dev) -> dict:
    import jax

    from paramugsy_tpu.ops.encode import bucket_size, pad_to
    from paramugsy_tpu.tree.distance import intersection_matrix, kmer_sketch

    n = bucket_size(max(len(g) for g in family))
    sk = np.stack(
        [np.asarray(kmer_sketch(jax.device_put(pad_to(g, n), dev), k=8)) for g in family]
    )
    t0 = time.perf_counter()
    got = np.asarray(intersection_matrix(jax.device_put(sk, dev)).block_until_ready())
    wall = time.perf_counter() - t0
    # Exact, TF32 included: {0,1} inputs and integer sums below 2^24.
    res = {"intersections_exact": bool(np.array_equal(got, sk @ sk.T)), "first_call_s": wall}
    log(f"tree: {json.dumps(res)}")
    if not res["intersections_exact"]:
        raise AssertionError("intersection_matrix differs from NumPy S @ S.T")
    return res


def phase_dp(seed: int, dev) -> dict:
    import bench
    from paramugsy_tpu.ops.extend import align_long_segment
    from paramugsy_tpu.ops.wavefront import wavefront_align_many

    pairs = bench.dp_pairs(np.random.default_rng(seed + 4))
    t0 = time.perf_counter()
    wavefront_align_many(pairs)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_out = wavefront_align_many(pairs)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_out = [align_long_segment(a, b) for a, b in pairs]
    host = time.perf_counter() - t0
    equal = sum(x == y for x, y in zip(dev_out, host_out))
    res = {
        "pairs": len(pairs),
        "equal_pairs": equal,
        "device_compile_s": cold - warm,
        "device_warm_s": warm,
        "host_banded_s": host,
        "peak_bytes_in_use": peak_bytes(dev),
    }
    log(f"dp: {json.dumps(res)}")
    if equal != len(pairs):
        raise AssertionError("device wavefront differs from the host engine")
    return res


def run_one_gpu(seed: int, work: str) -> int:
    import bench
    from paramugsy_tpu.ops import native

    rng = np.random.default_rng(seed)
    ref, qry = bench.build_pair(rng, PAIR_BP)
    family = bench.build_repeat_family(rng, FAMILY_BP, count=4)
    paths = {
        "work": work,
        "ref": write_fasta(os.path.join(work, "r.fa"), "r", ref),
        "qry": write_fasta(os.path.join(work, "q.fa"), "q", qry),
        "family": write_family(work, family, "g"),
    }
    # Build the native library once, before any child could race to it.
    if native.load() is None:
        raise RuntimeError("the native library did not build")
    procs = start_cpu_reference(paths)
    try:
        run_gpu_tests(work)
    except BaseException:
        kill_children(procs)
        raise
    wait_children(procs)

    devs = require_gpus(1)
    dev = devs[0]
    from paramugsy_tpu.ops import engines

    gpu_args = cli_args(paths, "gpu")
    warm_args = cli_args(paths, "gpu_warm")
    cli_phase("pair", gpu_args["pair"], warm_args["pair"], dev)
    cli_phase("multi", gpu_args["multi"], warm_args["multi"], dev)
    check_outputs(paths)
    phase_seeding(seed, dev)
    phase_tree(family, dev)
    phase_dp(seed, dev)
    log(f"engines (all phases): {json.dumps(engines.COUNTS)}")
    slow = [k for k in engines.COUNTS if k.startswith("numpy-")]
    if slow or "seedcluster-gpu" not in engines.COUNTS:
        raise AssertionError(f"host NumPy engines ran or no GPU seeding: {slow}")
    return len(devs)


def run_four_gpus(seed: int, work: str) -> int:
    import bench

    family = bench.build_repeat_family(np.random.default_rng(seed + 5), FAMILY_BP, count=8)
    paths = write_family(work, family, "s")
    # The multi-process run goes first: its children must have the cards
    # to themselves, since this process reserves all four once it opens them.
    t0 = time.perf_counter()
    dist_logs = wait_children(start_distributed_cli(work, paths, 4))
    dist_wall = time.perf_counter() - t0
    one_card = all(f"x1 (process {i} of 4)" in log_ for i, log_ in enumerate(dist_logs))
    devs = require_gpus(4)

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paramugsy_tpu.formats.maf import read_maf
    from paramugsy_tpu.ops.encode import bucket_size, pad_to
    from paramugsy_tpu.parallel.collective import align_fastas_sharded
    from paramugsy_tpu.parallel.mesh import make_mesh
    from paramugsy_tpu.parallel.pair_shard import make_sharded_distance_step
    from paramugsy_tpu.pipeline import Aligner, PipelineConfig, finalize_blocks, load_genome
    from paramugsy_tpu.tools.mafvalidate import find_faults
    from paramugsy_tpu.tree.distance import intersection_matrix, kmer_sketch

    def rows(bs):
        return sorted((s.name, s.start, s.size, s.strand, s.text) for b in bs for s in b.seqs)

    mesh = make_mesh(n_pairs=4, n_kdim=1, devices=devs[:4])
    t0 = time.perf_counter()
    align_fastas_sharded(paths, os.path.join(work, "sharded_cold.maf"), mesh=mesh)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = align_fastas_sharded(paths, os.path.join(work, "sharded.maf"), mesh=mesh)
    warm = time.perf_counter() - t0
    seq_walls = []
    for _ in range(2):  # the first run compiles
        t0 = time.perf_counter()
        seq = finalize_blocks(Aligner([load_genome(p) for p in paths], PipelineConfig()).run())
        seq_walls.append(time.perf_counter() - t0)

    n = bucket_size(max(len(g) for g in family))
    sk = np.stack(
        [np.asarray(kmer_sketch(jax.device_put(pad_to(g, n), devs[0]), k=8)) for g in family]
    )
    mesh_k = make_mesh(n_pairs=1, n_kdim=4, devices=devs[:4])
    j4 = np.asarray(
        make_sharded_distance_step(mesh_k)(
            jax.device_put(sk, NamedSharding(mesh_k, P(None, "kdim")))
        )
    )
    j1 = np.asarray(intersection_matrix(jax.device_put(sk, devs[0])))
    dist_equal = []
    for i in range(4):
        with open(os.path.join(work, f"dist{i}.maf")) as f:
            dist_equal.append(rows(read_maf(f)) == rows(seq))
    res = {
        "genomes": len(paths),
        "distributed_cli_wall_s": dist_wall,
        "distributed_one_card_each": one_card,
        "distributed_rows_equal_sequential": dist_equal,
        "sharded_compile_s": cold - warm,
        "sharded_warm_s": warm,
        "sequential_cold_s": seq_walls[0],
        "sequential_warm_s": seq_walls[1],
        "blocks": len(shard),
        "rows_equal_sequential": rows(shard) == rows(seq),
        "maf_faults": len(find_faults(shard)),
        "distance_equal_one_card": bool(np.array_equal(j4, j1)),
        "peak_bytes_in_use": [peak_bytes(d) for d in devs[:4]],
    }
    log(f"four-gpus: {json.dumps(res)}")
    if not (res["rows_equal_sequential"] and res["distance_equal_one_card"]) or res["maf_faults"]:
        raise AssertionError("sharded run differs from the one-card run")
    if not (one_card and all(dist_equal)):
        raise AssertionError("the multi-process run differs from the one-card run")
    return len(devs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four-gpus", action="store_true",
        help="run only the sharded phase on a 4-GPU mesh",
    )
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import bench

    from paramugsy_tpu.utils.cache import enable_compilation_cache

    card = bench.card_info()
    log(f"card: {card}")
    enable_compilation_cache()  # sets config only; opens no device
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_gpus:
            count = run_four_gpus(args.seed, work)
        else:
            count = run_one_gpu(args.seed, work)
    import jax

    d = jax.devices()[0]
    log(f"total wall {time.perf_counter() - t_start:.3f} s")
    log(f"card: {card}")
    print(
        json.dumps(
            {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": count}}
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
