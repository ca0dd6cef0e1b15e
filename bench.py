#!/usr/bin/env python
"""Headline benchmark: batched BandEd score-only throughput on the GPU.

Prints one JSON line per row; every row names the device it ran on
(platform, device_kind, device count). There is no CPU fallback: with
no GPU the script exits non-zero.

Headline row: the device score lane (the Pallas-Triton kernel) on
32,768 pairs x 5 kbp at 10 % error, 15 % band, timed end to end
(staging + kernel + readback, best of REPS after a warm-up), every score
checked against the host C kernel. `--workloads` adds the BASELINE.md
workload rows (benchmarks/run_workloads.py), run in this process (one
process per card).
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_PAIRS = 32768
LENGTH = 5000
ERROR = 0.10
BANDWIDTH = 15
REPS = 3


def _device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {devs[0].platform}")
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                device_count=len(devs))


def headline(device: dict) -> dict:
    import numpy as np

    from quicked_tpu import generate, native
    from quicked_tpu.ops import banded_triton as bt
    from quicked_tpu.ops.batch_prep import (extract_final_scores,
                                            prepare_banded_batch)
    from quicked_tpu.utils.host_threads import map_lanes

    pairs = generate.generate_pairs_bulk(N_PAIRS, LENGTH, ERROR, seed=7)
    batch = prepare_banded_batch(
        [p for p, _ in pairs], [t for _, t in pairs],
        [max(len(p), len(t)) * BANDWIDTH // 100 for p, t in pairs],
        full=False)
    batch.peq_lo                                 # host planes: set-up

    def run():
        return bt.run_banded_triton(batch)["scores_by_k"]

    got = extract_final_scores(batch, run())     # compile + warm
    want = np.zeros(N_PAIRS, np.int64)

    def one(i):
        want[i] = native.banded_score(
            batch.enc_patterns[i], batch.enc_texts[i], int(batch.cutoff[i]),
            int(batch.tlen[i]), int(batch.tfinish[i]))

    map_lanes(one, N_PAIRS)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    bases = sum(max(len(p), len(t)) for p, t in pairs)
    return dict(metric="banded_score_bases_per_s", value=bases / best,
                unit="bases/s", seconds=best,
                parity=bool(np.array_equal(got, want)), **device)


def main(workloads: bool = False):
    device = _device()
    from quicked_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    print(json.dumps(headline(device)), flush=True)
    if workloads:
        sys.path.insert(0, os.path.join(REPO, "benchmarks"))
        import run_workloads

        for w in (1, 2, 3, 4, 5):
            row = run_workloads.run_workload(w)
            print(json.dumps(dict(row, **device)), flush=True)


if __name__ == "__main__":
    main(workloads="--workloads" in sys.argv[1:])
