#!/usr/bin/env python
"""Smoke run of the main path on the GPU, at the sizes users run.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the meshed path only

Phases (one process holds the card; CPU-side references run in child
processes with JAX_PLATFORMS=cpu, which never open it):

  1. preflight: JAX must be on a GPU; prints the card's name and power
     limit (nvidia-smi, from a child process) and the JAX devices;
  2. headline score batch, 32,768 pairs x 5 kbp at 10 % error, 15 %
     band: the Triton kernel and the XLA scan, each staged, run and read
     back, every score checked against host C;
  3. full fills with CIGARs, 100,000 pairs x 100 bp at 2 %: the Triton
     full fill + on-device traceback, the XLA full scan + host walk and
     the host C fill+traceback, every CIGAR checked byte for byte;
  4. the cascade through its entry points (quicked_cascade_batch and
     the align_benchmark CLI) on 10,000 x 1 kbp, 1,000 x 10 kbp and
     16 x 30 kbp at 10 %: TSVs byte-identical to the CLI on the CPU
     backend, a routed run and a run with the staged device lane forced
     (QUICKED_TPU_STAGED_SHORT=1), whose venues must be device lanes;
     then the deep-band carry-scan's card time and the CPU-backend
     pins, each timed both ways;
  5. the tests marked `gpu` (tests/test_gpu.py), in this process.

--four runs a mixed-length batch (20,000 pairs, 150 bp - 10 kbp) under
use_mesh(make_mesh(4)) and on one card, and checks them bit-exact.

Any failed check raises: the script exits non-zero and prints no
result line. The last line of a passing run is the JSON result
{"ok": true, "device": {...}}; everything else comes before it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(**row):
    print(json.dumps(row, default=str), flush=True)


def best_of(fn, reps=3):
    fn()                                   # warm (compile + first run)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def cutoffs_for(pairs, bandwidth=15):
    return [max(len(p), len(t)) * bandwidth // 100 for p, t in pairs]


# ---------------------------------------------------------------- phase 1
def preflight(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(f"chip_smoke: needs {count} GPU(s); JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    emit(phase="preflight", jax=jax.__version__,
         device_kind=devs[0].device_kind, count=len(devs))
    return devs


# ---------------------------------------------------------------- phase 2
def host_c_scores(batch):
    import numpy as np

    from quicked_tpu import native
    from quicked_tpu.utils.host_threads import map_lanes

    n = len(batch.enc_patterns)
    out = np.zeros(n, np.int64)

    def one(i):
        out[i] = native.banded_score(
            batch.enc_patterns[i], batch.enc_texts[i], int(batch.cutoff[i]),
            int(batch.tlen[i]), int(batch.tfinish[i]))

    map_lanes(one, n)
    return out


def headline():
    import jax
    import numpy as np

    from quicked_tpu import generate
    from quicked_tpu.ops import banded_triton as bt
    from quicked_tpu.ops.banded_jax import _banded_scan
    from quicked_tpu.ops.batch_prep import (extract_final_scores,
                                            prepare_banded_batch)

    t0 = time.perf_counter()
    pairs = generate.generate_pairs_bulk(32768, 5000, 0.10, seed=7)
    n, length = len(pairs), len(pairs[0][1])
    batch = prepare_banded_batch([p for p, _ in pairs],
                                 [t for _, t in pairs], cutoffs_for(pairs),
                                 full=False)
    batch.peq_lo                             # build the planes now
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = host_c_scores(batch)
    emit(phase="headline", lane="host_c", pairs=n, length=length,
         EBB=batch.EBB, NB=batch.NB, prep_s=prep_s,
         host_c_s=time.perf_counter() - t0)

    def run(name, stage, compile_fn, readback):
        t0 = time.perf_counter()
        args = jax.block_until_ready(stage())
        stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = compile_fn(args)
        compile_s = time.perf_counter() - t0
        kernel_s = best_of(lambda: jax.block_until_ready(compiled(*args)))
        out = compiled(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        scores_by_k = readback(out)
        readback_s = time.perf_counter() - t0
        got = extract_final_scores(batch, scores_by_k)
        nbad = int(np.sum(got != want))
        emit(phase="headline", lane=name, stage_s=stage_s,
             compile_s=compile_s, kernel_s=kernel_s, readback_s=readback_s,
             e2e_s=stage_s + kernel_s + readback_s,
             bases_per_s=float(np.sum(np.maximum(batch.plen, batch.tlen))
                               / (stage_s + kernel_s + readback_s)),
             match_host_c=f"{n - nbad}/{n}", memory=memory(compiled))
        check(nbad == 0, f"headline {name}: {nbad} scores differ from host C")

    statics = dict(EBB=batch.EBB, NB=batch.NB)
    run("triton", lambda: bt.stage(batch)[0],
        lambda a: bt.banded_triton_call.lower(
            *a, **statics, full=False, lanes=bt.tile_lanes(n)).compile(),
        lambda out: np.asarray(out["scores_by_k"])[:, :n])
    plain = (batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
             batch.text, batch.init_scores, batch.cutoff, batch.prolog,
             batch.nbr, batch.finish_v, batch.tfinish, batch.first0,
             batch.last0)
    run("xla_scan", lambda: tuple(jax.device_put(a) for a in plain),
        lambda a: _banded_scan.lower(*a, **statics, full=False).compile(),
        lambda out: np.asarray(out["scores_by_k"]))


# ---------------------------------------------------------------- phase 3
def full_fills():
    import jax
    import numpy as np

    from quicked_tpu import generate, native
    from quicked_tpu.aligner.batch import _run_device_full_tb, bucket_keys
    from quicked_tpu.ops.banded_jax import run_banded
    from quicked_tpu.ops.banded_native import run_banded_full_native
    from quicked_tpu.ops.batch_prep import (extract_final_scores,
                                            prepare_banded_batch)

    pairs = generate.generate_pairs_bulk(100_000, 100, 0.02, seed=3)
    n = len(pairs)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = cutoffs_for(pairs)
    praws = [p.encode() for p in pats]
    traws = [t.encode() for t in txts]

    t0 = time.perf_counter()
    want_sc, want_ops = run_banded_full_native(pats, txts, cos)
    emit(phase="full", lane="full_host_c", pairs=n,
         e2e_s=time.perf_counter() - t0)

    keys = bucket_keys([len(p) for p in pats], [len(t) for t in txts], cos,
                       full=True)
    buckets: dict = {}
    for i, k in enumerate(keys):
        buckets.setdefault(k, []).append(i)
    batches = []
    for (nb, ebb), idxs in buckets.items():
        b = prepare_banded_batch([pats[i] for i in idxs],
                                 [txts[i] for i in idxs],
                                 [cos[i] for i in idxs], full=True,
                                 min_nb=nb, min_ebb=ebb)
        b.peq_lo
        batches.append((idxs, b))

    def device_lane():
        return [(idxs, _run_device_full_tb(
            b, [praws[i] for i in idxs], [traws[i] for i in idxs],
            len(idxs))) for idxs, b in batches]

    def xla_host_walk():
        res = []
        for idxs, b in batches:
            out = run_banded(b)
            mats = [np.ascontiguousarray(out[k])[None] for k in (
                "mat_pv_lo", "mat_pv_hi", "mat_mv_lo", "mat_mv_hi")]
            ops = native.traceback_banded_batch(
                mats, b.B, [praws[i] for i in idxs],
                [traws[i] for i in idxs],
                [int(b.prolog[j]) for j in range(len(idxs))])
            res.append((idxs, (extract_final_scores(b, out["scores_by_k"]),
                               ops)))
        return res

    def device_breakdown():
        """The device lane's steps timed apart (last bucket)."""
        from quicked_tpu.ops import banded_traceback_jax as btj
        from quicked_tpu.ops import banded_triton as bt

        idxs, b = batches[-1]
        pr, tr = [praws[i] for i in idxs], [traws[i] for i in idxs]
        steps = {}
        t0 = time.perf_counter()
        args, st = bt.stage(b)
        jax.block_until_ready(args)
        steps["stage_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(bt.run_staged(args, st))
        steps["fill_s"] = time.perf_counter() - t0
        Bp = args[-1].shape[0]
        t0 = time.perf_counter()
        frames = btj.prep_raw_frames(pr, tr, st["NB"] * W,
                                     max(32, 1 << (max(map(len, pr)) - 1)
                                         .bit_length()), pad_to_b=Bp)
        steps["raw_frames_s"] = time.perf_counter() - t0
        pad = lambda a: np.pad(a.astype(np.int32), (0, Bp - a.shape[0]))
        t0 = time.perf_counter()
        btj.traceback_ops_device([out[k] for k in bt.MAT_NAMES], *frames,
                                 pad(b.plen), pad(b.tlen), pad(b.prolog),
                                 EBB=st["EBB"], n=len(idxs))
        steps["traceback_readback_expand_s"] = time.perf_counter() - t0
        return steps

    device_breakdown()
    emit(phase="full", lane="full_triton_tb_steps", **device_breakdown())
    for name, fn in (("full_triton_tb", device_lane),
                     ("xla_scan_host_walk", xla_host_walk)):
        t0 = time.perf_counter()
        fn()                                   # compile + first run
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fn()
        e2e_s = time.perf_counter() - t0
        nbad = 0
        for idxs, (sc, ops) in res:
            for j, i in enumerate(idxs):
                nbad += (int(sc[j]) != int(want_sc[i])
                         or ops[j] != want_ops[i])
        emit(phase="full", lane=name, buckets=len(batches), first_s=first_s,
             e2e_s=e2e_s, match_host_c=f"{n - nbad}/{n}")
        check(nbad == 0, f"full {name}: {nbad} CIGARs differ from host C")


# ---------------------------------------------------------------- phase 4
DATASETS = (("1kbp", 10_000, 1_000, 11), ("10kbp", 1_000, 10_000, 12),
            ("30kbp", 16, 30_000, 13))


def cascade(tmp):
    from quicked_tpu import generate, seqio
    from quicked_tpu.aligner import batch as ab
    from quicked_tpu.aligner.cascade import quicked_cascade_batch
    from quicked_tpu.tools.align_benchmark import main as cli_main
    from quicked_tpu.utils import warmup

    cli = os.path.join(REPO, "tools", "align_benchmark")
    for name, n, length, seed in DATASETS:
        pairs = generate.generate_pairs_bulk(n, length, 0.10, seed=seed)
        n = len(pairs)
        seq = os.path.join(tmp, f"{name}.seq")
        seqio.write_seq_pairs(seq, pairs)
        out_cpu = os.path.join(tmp, f"{name}.cpu.tsv")
        out_gpu = os.path.join(tmp, f"{name}.gpu.tsv")
        t0 = time.perf_counter()
        ref = subprocess.run(
            [sys.executable, cli, "-a", "quicked", "-i", seq, "-o", out_cpu,
             "--platform", "cpu", "-q"], cwd=REPO, capture_output=True,
            text=True, timeout=1200,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        cpu_s = time.perf_counter() - t0
        check(ref.returncode == 0, f"cpu CLI {name}: {ref.stderr[-2000:]}")
        t0 = time.perf_counter()
        rc = cli_main(["-a", "quicked", "-i", seq, "-o", out_gpu, "-q"])
        gpu_s = time.perf_counter() - t0
        check(rc == 0, f"gpu CLI {name} exited {rc}")
        with open(out_cpu, "rb") as f1, open(out_gpu, "rb") as f2:
            same = f1.read() == f2.read()
        check(same, f"CLI TSV {name}: GPU output differs from --platform cpu")

        def timed(forced):
            if forced:
                os.environ["QUICKED_TPU_STAGED_SHORT"] = "1"
            try:
                quicked_cascade_batch(pairs)       # warm every shape
                warmup.wait_idle(600)
                quicked_cascade_batch(pairs)
                warmup.wait_idle(600)
                before = ab.venue_snapshot()
                t0 = time.perf_counter()
                res = quicked_cascade_batch(pairs)
                dt = time.perf_counter() - t0
                after = ab.venue_snapshot()
            finally:
                os.environ.pop("QUICKED_TPU_STAGED_SHORT", None)
            venues = {k: after[k] - before.get(k, 0) for k in after
                      if after[k] != before.get(k, 0)}
            return res, dt, venues

        routed, routed_s, routed_v = timed(False)
        forced, forced_s, forced_v = timed(True)
        emit(phase="cascade", dataset=name, pairs=n, length=length,
             cli_cpu_backend_s=cpu_s, cli_gpu_s=gpu_s, routed_s=routed_s,
             routed_venues=routed_v, forced_s=forced_s,
             forced_venues=forced_v, tsv_identical=same)
        check(list(routed.score) == list(forced.score)
              and routed.cigar == forced.cigar
              and [int(s) for s in routed.status]
              == [int(s) for s in forced.status],
              f"cascade {name}: forced staged lane differs from routed run")
        warming = [k for k in forced_v if k.endswith("_warming")]
        check(not warming, f"cascade {name}: warming venues {warming}")
        # full fills have no cost model: the device lane takes them all
        # (host C only for buckets too deep for one tile of planes)
        check("full_triton_tb" in forced_v,
              f"cascade {name}: no device full-fill lane in {forced_v}")


def plain_kernels_and_pins():
    """Card time of the deep-band carry-scan beside host C, and each
    former CPU-backend pin timed both ways."""
    import jax
    import numpy as np

    from quicked_tpu import generate
    from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan
    from quicked_tpu.ops.banded_native import run_banded_native
    from quicked_tpu.ops.batch_prep import (extract_final_scores,
                                            prepare_banded_batch)
    from quicked_tpu.ops.hirschberg_split_jax import hirschberg_split_batch
    from quicked_tpu.ops.windowed_jax import (prepare_windowed_batch,
                                              run_windowed_score)

    cpu = jax.devices("cpu")[0]
    pairs = generate.generate_pairs_bulk(16, 30_000, 0.10, seed=4)
    deep = prepare_banded_batch([p for p, _ in pairs],
                                [t for _, t in pairs], cutoffs_for(pairs),
                                full=False)
    want = host_c_scores(deep)
    for name, fn in (("cscan_xla", run_banded_cscan),
                     ("host_c", run_banded_native)):
        sk = fn(deep)["scores_by_k"]
        emit(phase="deep_band", lane=name, pairs=16, length=30_000,
             EBB=deep.EBB, e2e_s=best_of(lambda: fn(deep), reps=2))
        check(np.array_equal(extract_final_scores(deep, sk), want),
              f"deep band {name} differs from host C")

    size = 16384                       # a bucket the old pin sent to CPU
    long_pairs = generate.generate_pairs_bulk(16, 10_000, 0.10, seed=5)
    wb = prepare_windowed_batch([p for p, _ in long_pairs],
                                [t for _, t in long_pairs], window_size=9,
                                pad_to_b=16, min_t=size, min_p=size,
                                min_kp=size // W + 1)
    outs = {}
    for name, dev in (("gpu", None), ("cpu_backend", cpu)):
        outs[name] = run_windowed_score(wb, 40, 9, 1, device=dev)
        emit(phase="pin", op="windowed_score", bucket=size, pairs=16,
             device=name, e2e_s=best_of(
                 lambda: run_windowed_score(wb, 40, 9, 1, device=dev),
                 reps=2))
    check(all(np.array_equal(a, b) for a, b in
              zip(outs["gpu"], outs["cpu_backend"])),
          "windowed score differs between GPU and CPU backend")

    rng = np.random.default_rng(9)
    B, EBB, K1 = 256, 64, 256
    planes = [rng.integers(0, 2 ** 32, (EBB, B), dtype=np.uint32)
              for _ in range(8)]
    vec = lambda v: np.full(B, v, np.int32)
    sk = np.repeat((np.arange(K1, dtype=np.int32) * W)[:, None], B, axis=1)
    args = (*planes[:4], vec(0), vec(EBB - 1), sk, *planes[4:], vec(0),
            vec(EBB - 1), sk, vec(1), vec(EBB), vec(EBB * W - 100),
            vec(EBB * W - 90))
    outs = {}
    for name, dev in (("gpu", jax.devices()[0]), ("cpu_backend", cpu)):
        def call(dev=dev):
            with jax.default_device(dev):
                return [np.asarray(x) for x in
                        hirschberg_split_batch(*args, EBB=EBB)]
        outs[name] = call()
        emit(phase="pin", op="hirschberg_split_batch", tasks=B, EBB=EBB,
             device=name, e2e_s=best_of(call, reps=3))
    check(all(np.array_equal(a, b) for a, b in
              zip(outs["gpu"], outs["cpu_backend"])),
          "split op differs between GPU and CPU backend")


# ---------------------------------------------------------------- phase 5
def gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")


# ----------------------------------------------------------------- --four
def four_cards(devs):
    import numpy as np

    from quicked_tpu import generate
    from quicked_tpu.aligner.cascade import quicked_cascade_batch
    from quicked_tpu.parallel.mesh import make_mesh, use_mesh

    pairs = (generate.generate_pairs_bulk(16_000, 150, 0.03, seed=50)
             + generate.generate_pairs_bulk(3_500, 1_000, 0.08, seed=51)
             + generate.generate_pairs_bulk(500, 10_000, 0.12, seed=52))
    quicked_cascade_batch(pairs[:2000])       # warm the one-card lanes
    t0 = time.perf_counter()
    one = quicked_cascade_batch(pairs)
    one_s = time.perf_counter() - t0
    mesh = make_mesh(4)
    check(len({d.id for d in mesh.devices.flat}) == 4,
          f"mesh devices {mesh.devices}")
    with use_mesh(mesh):
        t0 = time.perf_counter()
        quicked_cascade_batch(pairs)           # compiles every shape
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = quicked_cascade_batch(pairs)
        four_s = time.perf_counter() - t0
    peaks = [d.memory_stats().get("peak_bytes_in_use", 0)
             for d in devs[:4]]
    emit(phase="four_cards", pairs=len(pairs), one_card_s=one_s,
         four_cards_cold_s=cold_s, four_cards_s=four_s,
         peak_bytes_in_use=peaks)
    check([int(s) for s in one.status] == [int(s) for s in four.status],
          "status differs between one card and four")
    check(np.array_equal(np.asarray(one.score), np.asarray(four.score)),
          "scores differ between one card and four")
    check(list(one.cigar) == list(four.cigar),
          "CIGARs differ between one card and four")
    check(all(p > 0 for p in peaks[1:]),
          f"cards 1-3 held no shard (peak bytes {peaks})")


def main(argv) -> int:
    four = "--four" in argv
    sys.path.insert(0, REPO)
    try:
        import quicked_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout",
              file=sys.stderr)
        return 3
    devs = preflight(4 if four else 1)
    from quicked_tpu.utils.cache import enable_compile_cache
    emit(phase="setup", compile_cache=enable_compile_cache())
    t0 = time.perf_counter()
    if four:
        four_cards(devs)
    else:
        headline()
        full_fills()
        with tempfile.TemporaryDirectory() as tmp:
            cascade(tmp)
        plain_kernels_and_pins()
        gpu_tests()
    emit(phase="done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
