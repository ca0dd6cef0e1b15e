#!/usr/bin/env python
"""BASELINE.md workload benchmarks (the five north-star configs).

Each workload yields one JSON row with cold + warm wall time, the
venues the router picked (aligner/batch.VENUE_COUNTS diff), and — when
the compiled C reference is available — the CPU single-thread
comparison on the same dataset.

  1 single     — one short pair, score+CIGAR latency
  2 ont        — the bundled ONT MinION pair (>=500 kbp), quicked
  3 short      — 100 bp x N pairs @ 2% err, full alignment (quicked)
  4 long       — 10-100 kbp @ 10% err, Hirschberg regime (quicked)
  5 mixed      — mixed-length stream, quicked (single host; multi-host
                 runs shard this by process)

Usage: python benchmarks/run_workloads.py [--workload N] [--scale F]
`bench.py` imports run_workload() to embed the same rows in the round
BENCH artifact.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ONT = "/root/reference/tests/test_data/ONT.MiniION.1.seq"


def _cpu_time(pairs, algorithm="quicked", extra=()):
    """Single-thread C reference wall time. NOTE: includes process exec
    + .seq parsing + output — comparable to _run_quicked only when the
    alignment dominates (large workloads); for tiny ones the JSON's
    speedup_vs_cpu mostly measures exec overhead."""
    from quicked_tpu import seqio

    bench = os.path.join(REPO, ".oracle", "bin", "align_benchmark")
    if not os.path.exists(bench):
        return None
    with tempfile.TemporaryDirectory() as td:
        seq = os.path.join(td, "w.seq")
        seqio.write_seq_pairs(seq, pairs)
        t0 = time.perf_counter()
        subprocess.run([bench, "-a", algorithm, "-i", seq, "-q",
                        *extra], check=True, capture_output=True,
                       timeout=3600)
        return time.perf_counter() - t0


def _run_quicked(pairs):
    from quicked_tpu.aligner.cascade import quicked_cascade_batch

    t0 = time.perf_counter()
    res = quicked_cascade_batch(pairs)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for s in res.status if int(s) >= 0)
    return dt, n_ok


#: Warm repetitions per side. Sub-second workloads on a shared host
#: swing 2-4x run-to-run; a single warm timing is noise. Engine
#: and C-reference reps are INTERLEAVED pairwise (engine rep i, then C
#: rep i, back-to-back) so both sides sample the same host load — a
#: co-located driver's background work otherwise lands on whichever
#: side happens to run later and flips the scoreboard sign (round 4:
#: sequential protocol measured the engine 2x slower warm than cold
#: while the C side ran on a quieter host seconds later).
REPS = int(os.environ.get("QUICKED_TPU_BENCH_REPS", "7"))


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _trimmed_spread(xs):
    """Spread with one outlier dropped per end (>=5 reps): one
    descheduled rep on either side must not un-decide a row that six
    other reps agree on. Applied identically to engine and reference;
    the untrimmed spread is recorded alongside."""
    s = sorted(xs)
    return (s[-2] - s[1]) if len(s) >= 5 else (s[-1] - s[0])


def _pinned_cpu_s(name, bases):
    """BASELINE.json's pinned single-thread C reference wall time for
    this workload (measured once on a quiet host, benchmarks/
    pin_baseline.py) — the stable cross-round denominator; the same-run
    denominator stays the decisive-scoreboard comparator. Only valid
    for the pinned dataset itself: a --scale run must not divide the
    pinned wall time by a differently-sized workload."""
    try:
        with open(os.path.join(REPO, "BASELINE.json")) as f:
            base = json.load(f)
        pb = base.get("pinned_cpu_bases", {}).get(name)
        if pb is not None and pb != bases:
            return None
        return base.get("pinned_cpu_s", {}).get(name)
    except Exception:
        return None


def _timed(name, pairs, warm_pairs=None, with_cpu=True):
    """Cold call, then REPS interleaved (engine, C reference) warm rep
    pairs; medians, spreads (full + trimmed), paired wins, venue diff —
    the standard row for every workload."""
    from quicked_tpu.aligner import batch as ab

    if warm_pairs is not None:
        _run_quicked(warm_pairs)      # pre-compile the bucket shapes
    t_cold, n_ok = _run_quicked(pairs)   # first full-size call
    # steady state for the warm reps: background kernel warmups
    # (utils/warmup cold-shape deferral) must not contend the cores
    from quicked_tpu.utils import warmup
    warmup.wait_idle()
    before = ab.venue_snapshot()         # venues: the first warm run —
    warms = [_run_quicked(pairs)[0]]     # one run's routing, and cold
    after = ab.venue_snapshot()          # (calibration) flips excluded
    venues = {k: after[k] - before.get(k, 0) for k in after
              if after[k] != before.get(k, 0)}
    warmup.wait_idle()
    cpus = []
    cpu_error = None
    if with_cpu:
        try:
            c0 = _cpu_time(pairs)
            if c0 is not None:
                cpus.append(c0)
        except Exception as e:          # oracle trouble must not kill rows
            cpu_error = str(e)[:120]
    for _ in range(max(REPS - 1, 0)):
        warms.append(_run_quicked(pairs)[0])
        if cpus:
            try:
                c = _cpu_time(pairs)
            except Exception as e:
                cpu_error = str(e)[:120]
                break
            if c is None:               # the oracle binary went away
                break
            cpus.append(c)
    warm = _median(warms)
    bases = sum(max(len(p), len(t)) for p, t in pairs)
    row = {
        "workload": name,
        "pairs": len(pairs),
        "bases": bases,
        "cold_s": round(t_cold, 3),
        "warm_s": round(warm, 3),
        "warm_reps": len(warms),
        "warm_spread_s": round(max(warms) - min(warms), 3),
        "warm_spread_trim_s": round(_trimmed_spread(warms), 3),
        "pairs_per_s": round(len(pairs) / warm, 2),
        "bases_per_s": round(bases / warm, 1),
        "ok": n_ok,
        "venues": venues,
    }
    if cpu_error:
        row["cpu_error"] = cpu_error
    if cpus:
        cpu_dt = _median(cpus)
        row["cpu_s"] = round(cpu_dt, 3)
        row["cpu_spread_s"] = round(max(cpus) - min(cpus), 3)
        row["cpu_spread_trim_s"] = round(_trimmed_spread(cpus), 3)
        row["speedup_vs_cpu"] = round(cpu_dt / warm, 2)
        # paired sign stats: rep i of both sides ran back-to-back
        npair = min(len(warms), len(cpus))
        row["paired_wins"] = sum(
            1 for i in range(npair) if cpus[i] > warms[i])
        row["paired_reps"] = npair
        # decisive when the median margin exceeds both trimmed spreads,
        # OR on a clean paired sweep with a real median margin (a 7/7
        # same-load sign test is p < 0.01; this VM's C binary hiccups
        # +60-80 ms on ~15% of execs, which can blow cpu_spread past
        # any margin on a 0.1 s workload while every paired rep still
        # agrees on the winner). Symmetric: an 0/7 sweep marks a
        # decisive LOSS the same way.
        margin = abs(cpu_dt - warm)
        ratio = cpu_dt / warm if warm > 0 else float("inf")
        sweep = npair >= 7 and (
            (row["paired_wins"] == npair and ratio >= 1.1)
            or (row["paired_wins"] == 0 and ratio <= 1 / 1.1))
        row["decisive"] = bool(
            (margin > row["warm_spread_trim_s"]
             and margin > row["cpu_spread_trim_s"]) or sweep)
    pinned = _pinned_cpu_s(name, bases)
    if pinned:
        row["cpu_s_pinned"] = pinned
        row["speedup_vs_cpu_pinned"] = round(pinned / warm, 2)
    return row


def pairs_w1(scale=1.0):
    from quicked_tpu import generate

    return list(generate.generate_pairs(1, 300, error=0.05, seed=1))


def pairs_w2(scale=1.0):
    from quicked_tpu import seqio

    if not os.path.exists(ONT):
        return None
    return list(seqio.read_seq_pairs(ONT))


def pairs_w3(scale=1.0):
    from quicked_tpu import generate

    n = int(100_000 * scale)
    return list(generate.generate_pairs(n, 100, error=0.02, seed=3))


def pairs_w4(scale=1.0):
    from quicked_tpu import generate

    n = max(int(16 * scale), 2)
    return list(generate.generate_pairs(n, 30_000, error=0.10, seed=4))


def pairs_w5(scale=1.0):
    from quicked_tpu import generate

    rngs = [(int(2000 * scale), 150, 0.03), (int(500 * scale), 1000, 0.08),
            (int(50 * scale), 10_000, 0.12)]
    pairs = []
    for i, (n, L, e) in enumerate(rngs):
        pairs += list(generate.generate_pairs(max(n, 1), L, error=e,
                                              seed=50 + i))
    return pairs


WORKLOAD_NAMES = {1: "1-single-pair", 2: "2-ont-minion",
                  3: "3-short-100bp", 4: "4-long-30kbp",
                  5: "5-mixed-stream"}
WORKLOAD_PAIRS = {1: pairs_w1, 2: pairs_w2, 3: pairs_w3, 4: pairs_w4,
                  5: pairs_w5}


def w1_single(scale=1.0):
    return _timed(WORKLOAD_NAMES[1], pairs_w1(scale))


def w2_ont(scale=1.0):
    pairs = pairs_w2(scale)
    if pairs is None:
        return {"workload": WORKLOAD_NAMES[2],
                "skipped": f"the ONT MinION pair is not at {ONT}"}
    return _timed(WORKLOAD_NAMES[2], pairs)


def w3_short(scale=1.0):
    pairs = pairs_w3(scale)
    return _timed(WORKLOAD_NAMES[3], pairs,
                  warm_pairs=pairs[:min(len(pairs), 1024)])


def w4_long(scale=1.0):
    return _timed(WORKLOAD_NAMES[4], pairs_w4(scale))


def w5_mixed(scale=1.0):
    return _timed(WORKLOAD_NAMES[5], pairs_w5(scale))


WORKLOADS = {1: w1_single, 2: w2_ont, 3: w3_short, 4: w4_long,
             5: w5_mixed}


def run_workload(n: int, scale: float = 1.0) -> dict:
    """One BASELINE workload -> its JSON row (bench.py entry point)."""
    return WORKLOADS[n](scale)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", type=int, default=None,
                    choices=(1, 2, 3, 4, 5),
                    help="run one workload (1-5); default: all")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on dataset sizes")
    ap.add_argument("--platform", default=None,
                    choices=("cpu", "gpu"),
                    help="force the JAX platform (default: JAX's own"
                         " choice, the GPU where there is one)")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from quicked_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    todo = [args.workload] if args.workload else [1, 2, 3, 4, 5]
    for w in todo:
        print(json.dumps(run_workload(w, args.scale)), flush=True)


if __name__ == "__main__":
    main()
