"""Benchmark harness: pairwise whole-genome alignment throughput on one GPU.

Prints the headline JSON line
    {"metric": ..., "value": N, "unit": ..., "detail": {...}}
right after the headline measurement, then runs time-budgeted extras
(quality mini-run, repeat-rich pair, device DP) and prints one final
enriched line with the same metric and value.  Every line names the
device (platform, kind, count) and the card's name and power limit.
Without a GPU it fails instead of measuring the CPU.

Budget: PARAMUGSY_BENCH_BUDGET seconds (default 480); every extra checks
the remaining budget before it starts.

Config: a synthetic bacterial-scale genome pair (ref + 1%-diverged query
with indels and an inversion), aligned end-to-end (device seeding and
clustering, chaining, extension) after a warm-up run that absorbs
compilation.

The enriched ``detail`` adds:
* ``quality``: blocks / core bp / SP identity / coverage faults of a
  4-genome multiple alignment sharing the headline's compiled shapes —
  the reference's own oracles (lib/mafstat/p_core.ml:71-89,
  lib/mafvalidate/main.ml:20-37);
* ``repeat_rich_mbp_per_s``: hostile-input (dispersed repeat family)
  throughput;
* ``device_dp_gcells_per_s``: the device wavefront engine on 64 x 16 kb
  banded alignments, checked pair for pair against the host C++ engine.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

T_START = time.monotonic()
BUDGET_S = float(os.environ.get("PARAMUGSY_BENCH_BUDGET", "480"))
GENOME_MBP = 2.0


def remaining() -> float:
    return BUDGET_S - (time.monotonic() - T_START)


def card_info() -> str:
    """The card's name and power limit, from a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def mutate(rng, g, rate):
    """Substitute a fraction `rate` of positions with another base."""
    g = g.copy()
    subs = rng.random(len(g)) < rate
    g[subs] = ((g[subs] + rng.integers(1, 4, size=int(subs.sum()))) % 4).astype(np.int8)
    return g


def build_pair(rng, n):
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    q = mutate(rng, ref, 0.01)
    # a few indels + one inversion, applied in numpy code space
    q = np.concatenate([q[: n // 3], q[n // 3 + 12 :]])
    ins = rng.integers(0, 4, size=9).astype(np.int8)
    q = np.concatenate([q[: n // 2], ins, q[n // 2 :]])
    a, b = 2 * n // 3, 2 * n // 3 + 20000
    inv = (3 - q[a:b])[::-1].copy()
    q = np.concatenate([q[:a], inv, q[b:]])
    return ref, q


def plant_repeats(rng, g, unit=4000, copies=40, div=0.05):
    """Overwrite `copies` random sites of g with copies of one `unit`-bp
    element, each diverged by `div` — a dispersed repeat family."""
    element = rng.integers(0, 4, size=unit).astype(np.int8)
    for s in rng.choice(len(g) - unit, size=copies, replace=False):
        g[s : s + unit] = mutate(rng, element, div)
    return g


def build_repeat_rich_pair(rng, n, unit=4000, copies=40):
    """A pair whose ref carries a dispersed repeat family (`copies` copies
    of a `unit`-bp element at ~95% identity) — hostile input for unique-
    k-mer seeding, unlike the headline pair."""
    ref = plant_repeats(rng, rng.integers(0, 4, size=n).astype(np.int8), unit, copies)
    q = mutate(rng, ref, 0.01)
    q = np.concatenate([q[: n // 2], q[n // 2 + 17 :]])
    return ref, q


def build_repeat_family(rng, n, count=4, div=0.01):
    """`count` genomes from one ancestor that carries a dispersed repeat
    family (40 x 4 kb at ~95% identity): each with `div` substitutions and
    small indels; genome 1 also carries one 20 kb inversion."""
    anc = plant_repeats(rng, rng.integers(0, 4, size=n).astype(np.int8))
    genomes = []
    for i in range(count):
        g = mutate(rng, anc, div)
        g = np.delete(g, rng.integers(0, len(g), size=5))
        for p in np.sort(rng.integers(0, len(g), size=5))[::-1]:
            g = np.insert(g, p, rng.integers(0, 4, size=int(rng.integers(1, 10))))
        if i == 1:
            a = n // 3
            g[a : a + 20000] = (3 - g[a : a + 20000])[::-1]
        genomes.append(g.astype(np.int8))
    return genomes


def build_family(rng, n, count=4, div=0.005):
    """`count` genomes independently diverged from one ancestor — the
    quality mini-run's input (same length as the headline pair, so the
    whole multiple alignment reuses the headline's compiled shapes)."""
    from paramugsy_tpu.pipeline import Genome

    bases = np.array(list("ACGT"))
    anc = rng.integers(0, 4, size=n).astype(np.int8)
    genomes = []
    for i in range(count):
        g = mutate(rng, anc, div)
        # one small indel each so coordinates differ
        g = np.delete(g, rng.integers(0, n, size=5))
        genomes.append(
            Genome(name=f"q{i}", seqs={f"q{i}.chr": "".join(bases[g])})
        )
    return genomes


def dp_pairs(rng, n_pairs=64, length=16384):
    """Long-segment DP workload: 16 kb pairs with 20 deletions and 2%
    substitutions (band 512)."""
    pairs = []
    for _ in range(n_pairs):
        a = rng.integers(0, 4, size=length).astype(np.int8)
        b = np.delete(a, rng.choice(length, 20, replace=False)).copy()
        pairs.append((a, mutate(rng, b, 0.02)))
    return pairs


def bench_align(ref, query, names, cfg, align_pair, device_cache, reps=5):
    dt = float("inf")
    entries = []
    for _ in range(reps):
        t0 = time.perf_counter()
        entries = align_pair(ref, query, *names, cfg, device_cache=device_cache)
        dt = min(dt, time.perf_counter() - t0)
    aligned = sum(e.alignment_length() for e in entries)
    return aligned / 1e6 / dt, entries, dt


def bench_device_dp(rng, reps=3):
    """The device wavefront engine, from host arrays to host results,
    checked pair for pair against the host C++ banded engine."""
    from paramugsy_tpu.ops.extend import align_long_segment
    from paramugsy_tpu.ops.wavefront import wavefront_align_many

    pairs = dp_pairs(rng)
    res = wavefront_align_many(pairs)  # warm-up / compile
    for i, (a, b) in enumerate(pairs):
        if res[i] != align_long_segment(a, b):
            raise AssertionError(f"device/host DP mismatch on pair {i}")
    dt = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        wavefront_align_many(pairs)
        dt = min(dt, time.perf_counter() - t0)
    cells = sum(len(a) * 512 for a, _ in pairs)
    return cells / dt / 1e9


def bench_quality(rng, n):
    """4-genome multiple alignment -> the reference's quality oracles,
    with the per-phase wall breakdown."""
    from paramugsy_tpu.pipeline import Aligner, PipelineConfig, finalize_blocks
    from paramugsy_tpu.tools.mafstat import compute_stats
    from paramugsy_tpu.tools.mafvalidate import find_faults
    from paramugsy_tpu.utils.obs import METRICS

    genomes = build_family(rng, n)
    before = {k: v.total_s for k, v in METRICS.phases.items()}
    t0 = time.perf_counter()
    blocks = finalize_blocks(Aligner(genomes, PipelineConfig()).run())
    wall = time.perf_counter() - t0
    phases = {
        k: v.total_s - before.get(k, 0.0)
        for k, v in sorted(METRICS.phases.items())
        if v.total_s - before.get(k, 0.0) > 0.0005
    }
    st = compute_stats(blocks)
    return {
        "genomes": len(genomes),
        "genome_mbp": n / 1e6,
        "blocks": len(blocks),
        "core_bp": st.core_bp,
        "sp_identity": st.sp_identity,
        "coverage_faults": len(find_faults(blocks)),
        "wall_s": wall,
        "phases_s": phases,
    }


def _watchdog_no_headline() -> None:
    print(
        f"BENCH WATCHDOG: no headline after {BUDGET_S + 60:.0f}s "
        "(device init hang or compile storm); aborting.",
        flush=True,
    )
    os._exit(3)


def main() -> None:
    import threading

    watchdog = threading.Timer(BUDGET_S + 60, _watchdog_no_headline)
    watchdog.daemon = True
    watchdog.start()

    card = card_info()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")

    from paramugsy_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from paramugsy_tpu.ops import engines
    from paramugsy_tpu.ops.align_pair import AlignConfig, align_pair

    n = int(GENOME_MBP * 1e6)
    rng = np.random.default_rng(12345)
    ref, query = build_pair(rng, n)
    cfg = AlignConfig()
    device_cache: dict = {}

    # Warm-up: compiles (or loads from the persistent cache) the device
    # kernels for this bucket shape; its wall is the set-up cost.
    t0 = time.perf_counter()
    _ = align_pair(ref, query, "bench.r", "bench.q", cfg, device_cache=device_cache)
    warmup_s = time.perf_counter() - t0

    mbp_per_s, entries, dt = bench_align(
        ref, query, ("bench.r", "bench.q"), cfg, align_pair, device_cache
    )

    detail = {
        "genome_mbp": GENOME_MBP,
        "entries": len(entries),
        "aligned_bp": sum(e.alignment_length() for e in entries),
        "wall_s": dt,
        "warmup_s": warmup_s,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "card": card,
        "dp_engines": dict(engines.COUNTS),
        "headline_elapsed_s": time.monotonic() - T_START,
    }
    line = {
        "metric": "aligned_mbp_per_s_per_gpu",
        "value": mbp_per_s,
        "unit": "Mbp/s",
        "detail": detail,
    }
    print(json.dumps(line), flush=True)
    watchdog.cancel()

    # A device hang inside an extra must not lose the headline: the guard
    # prints a copy of what was measured and exits.
    def _abort_extras():
        try:
            aborted = dict(detail, extras_aborted="an extra hung after the headline")
            print(json.dumps(dict(line, detail=aborted)), flush=True)
        finally:
            os._exit(0)

    tail_guard = threading.Timer(max(remaining(), 0) + 60, _abort_extras)
    tail_guard.daemon = True
    tail_guard.start()

    # Budgeted extras, each skipped rather than partial; engine counts are
    # recorded per section so the headline's mix stays separate.
    def engines_delta(before):
        return {
            k: v - before.get(k, 0)
            for k, v in engines.COUNTS.items()
            if v - before.get(k, 0)
        }

    if remaining() > 40:
        try:
            snap = dict(engines.COUNTS)
            q = bench_quality(rng, n)
            q["dp_engines"] = engines_delta(snap)
            gates = []
            if q["core_bp"] < 1_990_000:
                gates.append(f"core_bp {q['core_bp']} < 1990000")
            if q["sp_identity"] < 0.985:
                gates.append(f"sp_identity {q['sp_identity']} < 0.985")
            if q["coverage_faults"]:
                gates.append(f"{q['coverage_faults']} coverage faults")
            if gates:
                q["REGRESSION"] = gates
            detail["quality"] = q
        except Exception as e:  # never lose the headline over an extra
            detail["quality_error"] = repr(e)

    if remaining() > 35:
        try:
            snap = dict(engines.COUNTS)
            rr_ref, rr_query = build_repeat_rich_pair(rng, n)
            rr_mbp_per_s, rr_entries, _ = bench_align(
                rr_ref, rr_query, ("bench.rr", "bench.rq"), cfg,
                align_pair, device_cache,
            )
            detail["repeat_rich_mbp_per_s"] = rr_mbp_per_s
            detail["repeat_rich_entries"] = len(rr_entries)
            detail["repeat_rich_dp_engines"] = engines_delta(snap)
        except Exception as e:
            detail["repeat_rich_error"] = repr(e)

    if remaining() > 30:
        try:
            snap = dict(engines.COUNTS)
            detail["device_dp_gcells_per_s"] = bench_device_dp(rng)
            detail["device_dp_dp_engines"] = engines_delta(snap)
        except Exception as e:
            detail["device_dp_error"] = repr(e)

    detail["dp_engines_all_sections"] = dict(engines.COUNTS)
    detail["total_elapsed_s"] = time.monotonic() - T_START
    tail_guard.cancel()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
