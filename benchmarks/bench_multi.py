"""BASELINE configs 3-5 (CI-scale): N-genome multiple alignment wall-clock.

Synthetic ancestor-derived genomes (size/count configurable) through the
concurrent executor; reports genome-pairs/s and end-to-end wall on one
GPU, naming the device and the card.  Without a GPU it fails.

Run:  python benchmarks/bench_multi.py -n 8 -size 500000 -j 4
"""
import argparse
import json
import sys
import os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import numpy as np

from paramugsy_tpu.pipeline import Aligner, Genome, PipelineConfig
from paramugsy_tpu.runtime.executor import JobExecutor
from paramugsy_tpu.tools.mafvalidate import find_faults


def build_genomes(n_genomes: int, size: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    anc = "".join(bases[rng.integers(4, size=size)])
    out = []
    for i in range(n_genomes):
        s = list(anc)
        for j in rng.choice(size, size // 80, replace=False):
            s[j] = "ACGT"[rng.integers(4)]
        out.append(Genome(f"g{i:02d}", {f"g{i:02d}.chr": "".join(s)}))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=8, help="genome count")
    ap.add_argument("-size", type=int, default=200_000, help="genome bp")
    ap.add_argument("-j", type=int, default=4, help="run_size (slots)")
    ap.add_argument("-chunk", type=int, default=8, help="pairs per device dispatch")
    args = ap.parse_args()

    from bench import card_info

    card = card_info()
    import jax

    from paramugsy_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_multi measures a GPU; JAX found {dev.platform}")
    enable_compilation_cache()
    genomes = build_genomes(args.n, args.size)
    cfg = PipelineConfig()
    tree = Aligner(genomes, cfg).job_tree()
    n_pairs = len(tree.all_pairwise())

    # Warm-up: a FULL untimed run absorbs compiles, in-process traces and
    # persistent-cache loads for every shape the timed run touches.
    JobExecutor(genomes, cfg, run_size=args.j, chunk_size=args.chunk).execute(tree)

    t0 = time.perf_counter()
    blocks = JobExecutor(genomes, cfg, run_size=args.j, chunk_size=args.chunk).execute(tree)
    dt = time.perf_counter() - t0
    faults = find_faults(blocks)
    print(json.dumps({
        "metric": "genome_pairs_per_s",
        "value": round(n_pairs / dt, 3),
        "unit": "pairs/s",
        "detail": {
            "genomes": args.n,
            "genome_bp": args.size,
            "pairs": n_pairs,
            "wall_s": dt,
            "chunk": args.chunk,
            "blocks": len(blocks),
            "coverage_faults": len(faults),
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            },
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
