"""Batch-first alignment engine.

The unit of work is a batch of pairs (SURVEY.md §7): pairs are bucketed by
band/text geometry into fixed-shape kernel invocations (bounded number of
XLA compilations), aligned on the lane the device's table names
(aligner/lanes.py), and results are scattered back to the input order —
the batched re-expression of the reference's per-pair driver loop
(quicked.c:405-437) + OpenMP batch loop (align_benchmark.c:232-306).
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from quicked_tpu import dna
from quicked_tpu.cigar import Cigar
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.batch_prep import prepare_banded_batch, extract_final_scores
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.traceback_np import banded_traceback_batch
from quicked_tpu.params import (
    QuickedAlgo,
    QuickedParams,
    QuickedStatus,
)

W = 64


@dataclasses.dataclass
class BatchResult:
    """Per-pair alignment results, in input order."""

    status: list
    score: np.ndarray
    cigar: list


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _raw_bytes(s) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return s
    return np.frombuffer(s.encode("ascii", errors="replace"), dtype=np.uint8)


def bucket_keys(plens, tlens, cutoffs, full: bool):
    """Bucket key per pair: (pow2(NB), pow2(EBB)) so the number of XLA
    compilations is O(log^2) in the size range, not O(pairs)."""
    keys = []
    for pl, tl, co in zip(plens, tlens, cutoffs):
        geo = myers_np.band_geometry(int(pl), int(tl), int(co))
        if full:
            ebb = geo.ebb
        else:
            ebb = myers_np.div_ceil(geo.cutoff, W) + 1
        nb = max(myers_np.div_ceil(int(tl), W), 1)
        keys.append((_next_pow2(nb), _next_pow2(ebb)))
    return keys


# Memory budget for one full-matrix (traceback) kernel invocation: the
# stored band snapshots are NB*64*EBB*16 bytes per lane (4 u32 planes).
FULL_FILL_BYTES_BUDGET = 1 << 30

_LINK_MBPS: list = []    # cached device->host readback bandwidth probe

# One probe at a time: the Hirschberg driver runs forward/reverse half
# passes on concurrent threads, and two simultaneous probes would time
# each other's transfers (halving the measured bandwidth, inflating the
# dispatch latency) and cache the contended numbers for the process
# lifetime. Reentrant: rate calibration holds it while consuming the
# link/dispatch probes.
_PROBE_LOCK = threading.RLock()

# Full (traceback) fills on the device read back ~3 bytes/column of
# (d_run, op) records from the on-device traceback, plus a raw-frame
# upload. Below this device<->host bandwidth the transfer outweighs the
# host C fill+traceback it replaces; a directly attached card clears it
# by two orders of magnitude.
FULL_DEVICE_TB_MIN_MBPS = 25.0

# The Hirschberg driver issues base-case fills as sequential per-level
# chunks, each paying several dispatches plus the records round trip,
# so a link with remote-dispatch latency loses end to end at any
# bandwidth; a local card dispatches in tens of microseconds.
FULL_DEVICE_MAX_DISPATCH_S = 0.005


_PROBE_TTL_S = 900.0  # link conditions drift with load


def _probe_cache_path() -> str:
    from quicked_tpu.utils.cache import state_dir

    return os.path.join(state_dir(), "device_probes.json")


def _probe_cache_get(key: str, ttl: float | None = None):
    """Cross-process probe memo: a fresh CLI process otherwise re-pays
    the 8 MB readback probe on its first routed batch. TTL-bounded;
    QUICKED_TPU_PROBE_CACHE=0 disables."""
    if os.environ.get("QUICKED_TPU_PROBE_CACHE", "1") != "1":
        return None
    import json
    import time

    try:
        with open(_probe_cache_path()) as f:
            data = json.load(f)
        ent = data.get(key)
        if ent and time.time() - ent["ts"] <= (ttl if ttl is not None
                                               else _PROBE_TTL_S):
            return float(ent["value"])
    except (OSError, ValueError, KeyError):
        pass
    return None


def _probe_cache_put(key: str, value: float) -> None:
    if os.environ.get("QUICKED_TPU_PROBE_CACHE", "1") != "1":
        return
    import json
    import time

    path = _probe_cache_path()
    try:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[key] = {"value": value, "ts": time.time()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _device_readback_mbps() -> float:
    """One-time probe of device->host transfer bandwidth (MB/s)."""
    with _PROBE_LOCK:
        if not _LINK_MBPS:
            cached = _probe_cache_get("readback_mbps")
            if cached is not None:
                _LINK_MBPS.append(cached)
                return cached
            import time

            import jax
            import jax.numpy as jnp

            buf = jax.device_put(jnp.zeros((8, 1024, 1024), jnp.uint8))
            buf.block_until_ready()
            t0 = time.perf_counter()
            np.asarray(buf)
            dt = max(time.perf_counter() - t0, 1e-9)
            _LINK_MBPS.append(8.0 / dt)
            # The in-process lock can't stop ANOTHER process's live
            # transfers from contending the probe; a sub-1 MB/s reading
            # (observed 0.14 MB/s during a concurrent bench) is a
            # transient outage, not an operating point — this process
            # honors it (routing host during an outage is right) but it
            # must not poison other processes through the cache.
            if _LINK_MBPS[0] >= 1.0:
                _probe_cache_put("readback_mbps", _LINK_MBPS[0])
    return _LINK_MBPS[0]


_DISPATCH_S: list = []

# Host C wavefront kernel: ~1.1e8 block-advances/s/core on a 4-core
# x86 host. The floor when first-use host calibration declines; device
# kernels have no such floor — their rates are measured on the card.
HOST_ADV_PER_S_PER_CORE = 1.1e8

# --- first-use kernel-rate calibration ---------------------------------
# Kernel rates are host/card properties that drift only with hardware,
# so they persist in the probe cache for days (the link/dispatch probes
# keep their short TTL).
_RATE_TTL_S = 7 * 86400.0
_RATES: dict = {}           # per-process memo: family -> advances/s

# Calibration geometries (batch size, pair length) chosen so each
# device family routes to itself and the kernel term is big enough to
# time: a batch that fills the card for the pairs-as-lanes kernel, deep
# bands for the carry-scan.
_CAL_GEOM = {
    "triton": (16384, 2_000),
    "cscan": (4, 30_000),
}


def _rate_fallback(family: str) -> float:
    if family == "host":
        return HOST_ADV_PER_S_PER_CORE * max(os.cpu_count() or 1, 1)
    raise RuntimeError(f"no measured rate for the {family!r} device kernel "
                       "(calibration is off or declined)")


def _calibrate_host_rate():
    """Marginal whole-host C-kernel rate from a two-size timed run
    (the difference cancels thread-pool spin-up and per-call fixed
    costs). ~0.3 s once per host, then cached for _RATE_TTL_S.

    force_scalar is pinned OFF during the timing: the venue model's
    est_host prices the DEFAULT (vector + threaded) host path, and a
    scalar-mode measurement persisted for 7 days would mis-route every
    later process. Best-of-3 min per size also bounds (not eliminates)
    contamination from concurrent alignment threads — the fallback
    constants remain the floor if a host measures implausibly."""
    from quicked_tpu import native as _native
    from quicked_tpu.ops.banded_native import (native_available,
                                               run_banded_native)
    if not native_available():
        return None
    import time

    from quicked_tpu import generate
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    def timed(L):
        pairs = list(generate.generate_pairs(4, L, error=0.1, seed=5))
        cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
        b = prepare_banded_batch([p for p, _ in pairs],
                                 [t for _, t in pairs], cos, full=False)
        adv = _deep_band_advances(b)
        run_banded_native(b)                    # warm pool + page faults
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run_banded_native(b)
            best = min(best, time.perf_counter() - t0)
        return adv, best

    prev = _native.get_force_scalar()
    _native.set_force_scalar(False)
    try:
        a1, t1 = timed(12_000)
        a2, t2 = timed(48_000)
    finally:
        _native.set_force_scalar(prev)
    if t2 - t1 <= 1e-4 or a2 <= a1:
        return None
    return (a2 - a1) / (t2 - t1)


def _calibrate_device_rate(family: str):
    """Time one real batch through the family's device kernel and
    invert the router's own estimate (dispatch + upload + adv/rate =
    wall) for rate — self-consistent with how the estimate is consumed.
    Only the device's own table may ask: a platform whose table has no
    device lanes raises."""
    from quicked_tpu.aligner import lanes

    if lanes.current().host_first:
        raise lanes.UnsupportedPlatform(
            f"{lanes.current().platform!r} has no device kernel lanes")
    import logging
    import time

    # The calibration batch is a real workload; say so once instead of
    # silently delaying the user's first routed call (results are
    # cached for 7 days).
    logging.getLogger("quicked_tpu").info(
        "calibrating %s kernel rate on first use (one-off, cached)",
        family)

    from quicked_tpu import generate
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    B, L = _CAL_GEOM[family]
    pairs = generate.generate_pairs_bulk(B, L, 0.1, 5)
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    batch = prepare_banded_batch([p for p, _ in pairs],
                                 [t for _, t in pairs], cos, full=False)
    if family == "triton":
        from quicked_tpu.ops.banded_triton import run_banded_triton as run
    else:
        from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan as run
    adv = _deep_band_advances(batch)
    run(batch)                                  # compile + warm
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        run(batch)                              # returns host arrays
        best = min(best, time.perf_counter() - t0)
    bytes_up = batch.upload_bytes(packed_text=(family == "triton"))
    overhead = _device_dispatch_s() + bytes_up / (_device_readback_mbps()
                                                  * 1e6)
    return adv / max(best - overhead, 0.1 * best)


def _kernel_rate(family: str) -> float:
    """Block-advances/s for a kernel family ('host', 'triton',
    'cscan'). Resolution order: process memo -> probe cache (TTL 7
    days) -> first-use calibration (persisted) -> for the host only,
    the HOST_ADV_PER_S_PER_CORE floor. A device family with no measured
    rate raises. QUICKED_TPU_CALIBRATE=0 skips calibration."""
    if family in _RATES:
        return _RATES[family]
    with _PROBE_LOCK:
        if family in _RATES:
            return _RATES[family]
        cached = _probe_cache_get(f"adv_rate_{family}", ttl=_RATE_TTL_S)
        if cached is not None and cached > 0:
            _RATES[family] = cached
            return cached
        rate = None
        if os.environ.get("QUICKED_TPU_CALIBRATE", "1") == "1":
            if family == "host":
                rate = _calibrate_host_rate()
            else:
                rate = _calibrate_device_rate(family)
        if rate is not None and rate > 0:
            _probe_cache_put(f"adv_rate_{family}", float(rate))
        else:
            rate = _rate_fallback(family)
        _RATES[family] = float(rate)
    return _RATES[family]


def _device_dispatch_s() -> float:
    """One-time probe of per-call device dispatch latency (seconds).
    Times the second call of a trivial jitted op so compile time is
    excluded; materializes the output (async dispatch under-reports)."""
    with _PROBE_LOCK:
        if not _DISPATCH_S:
            import time

            import jax
            import jax.numpy as jnp

            f = jax.jit(lambda a: a * 2)
            x = jnp.arange(256)
            np.asarray(f(x))
            t0 = time.perf_counter()
            np.asarray(f(x))
            _DISPATCH_S.append(max(time.perf_counter() - t0, 1e-6))
    return _DISPATCH_S[0]


def _deep_band_advances(batch) -> float:
    """Upper-bound block-advance count for a score batch."""
    n = len(batch.enc_patterns) if batch.enc_patterns is not None \
        else batch.B
    ebb = batch.cutoff[:n].astype(np.int64) // W + 1
    return float(np.sum(batch.tfinish[:n].astype(np.int64) * ebb))


def _score_device_est_s(batch, adv: float, kernel_adv_per_s: float,
                        packed_text: bool = True) -> float:
    """Estimated wall time of a device score pass: dispatch latency +
    input staging over the measured link + kernel time. The staging
    term is what high-latency links are actually bound by (the PEQ/
    level-mask/text planes upload on every engine call)."""
    bytes_up = batch.upload_bytes(packed_text=packed_text)
    link = _device_readback_mbps() * 1e6
    return (_device_dispatch_s() + bytes_up / link
            + adv / kernel_adv_per_s)


def _prefer_host_deep(batch) -> bool:
    """Deep-band venue decision: True when the estimated whole-host C
    time undercuts dispatch + staging + the XLA carry-scan's time. Both
    rates come from _kernel_rate (cache -> calibration)."""
    adv = _deep_band_advances(batch)
    est_host = adv / _kernel_rate("host")
    est_dev = _score_device_est_s(batch, adv, _kernel_rate("cscan"),
                                  packed_text=False)
    return est_host < est_dev


def _prefer_host_shallow(batch, n_live: int) -> bool:
    """Shallow-band venue decision: the pairs-as-lanes kernel's rate is
    measured on a batch that fills the card (_CAL_GEOM); below that its
    time stops shrinking with the batch, so the rate scales with
    occupancy (e.g. Hirschberg levels over a handful of pairs can lose
    to the host C kernel)."""
    adv = _deep_band_advances(batch)
    est_host = adv / _kernel_rate("host")
    occ = max(min(n_live / _CAL_GEOM["triton"][0], 1.0), 1e-3)
    est_dev = _score_device_est_s(batch, adv, _kernel_rate("triton") * occ)
    return est_host < est_dev


# Venue observability: batches routed per kernel family since process
# start (reset-free; consumers snapshot and diff). The workload bench
# records these per run so BENCH artifacts show WHERE work executed —
# a silent routing regression (e.g. the round-2 probe crash) is then
# visible as a venue shift, not just a timing blip.
VENUE_COUNTS: dict = {}
_VENUE_LOCK = threading.Lock()   # Hirschberg fwd/rev threads route
                                 # concurrently; a bare dict RMW would
                                 # drop increments

# Active device mesh (parallel.mesh.use_mesh): when set, every batched
# banded kernel call in the engine — cascade score passes, Hirschberg
# levels, full fills — executes sharded over it instead of single-
# device. This is the single-process multi-chip execution mode; the
# multi-HOST mode (parallel/distributed.py) shards the input stream
# instead.
ACTIVE_MESH = None


def _venue(name: str) -> None:
    with _VENUE_LOCK:
        VENUE_COUNTS[name] = VENUE_COUNTS.get(name, 0) + 1


def venue_snapshot() -> dict:
    with _VENUE_LOCK:
        return dict(VENUE_COUNTS)


def _device_with_cold_deferral(family: str, batch, run_dev):
    """Run the device kernel for this batch, with first-contact latency
    control (utils/warmup): when this bucket shape's device kernel
    hasn't executed in-process yet, serve the batch from the bit-exact
    host C kernel and compile/warm the device kernel in the background;
    later calls with the same shape take the device inline."""
    from quicked_tpu.ops.banded_native import (native_available,
                                               run_banded_native)
    from quicked_tpu.utils import warmup

    key = (family, batch.B, batch.EBB, batch.NB, bool(batch.full))
    if native_available() and batch.enc_patterns is not None and \
            warmup.defer_cold(key, lambda: run_dev(batch)):
        _venue(family + "_warming")
        _venue("host_c")
        return run_banded_native(batch)
    _venue(family)
    out = run_dev(batch)
    warmup.mark_warm(key)
    return out


def _run_banded_auto(batch):
    """Run a banded batch on the lane the device's table names
    (aligner/lanes.py). Score batches: host C first on the CPU; on the
    GPU, deep bands go to host C or the XLA carry-scan and shallow bands
    to host C or the pairs-as-lanes device kernel, by estimated time.
    Everything else (no native library, full batches on the mesh or
    off the device full lane) runs the XLA scan."""
    if ACTIVE_MESH is not None:
        from quicked_tpu.parallel.mesh import run_banded_sharded
        _venue("mesh_banded")
        return run_banded_sharded(batch, ACTIVE_MESH)
    if not batch.full:
        from quicked_tpu.aligner import lanes
        from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan
        from quicked_tpu.ops.banded_native import (native_available,
                                                   run_banded_native)

        table = lanes.current()
        host_ok = native_available() and batch.enc_patterns is not None
        if table.host_first:
            if host_ok:
                _venue("host_c")
                return run_banded_native(batch)
        elif lanes.is_deep(batch.EBB):
            if host_ok and _prefer_host_deep(batch):
                _venue("host_c")
                return run_banded_native(batch)
            return _device_with_cold_deferral("cscan_xla", batch,
                                              run_banded_cscan)
        else:
            if host_ok and _prefer_host_shallow(batch,
                                                len(batch.enc_patterns)):
                _venue("host_c")
                return run_banded_native(batch)
            if table.score_kernel == "triton":
                from quicked_tpu.ops.banded_triton import run_banded_triton
                return _device_with_cold_deferral("triton", batch,
                                                  run_banded_triton)
    _venue("xla_scan")
    return run_banded(batch)


def _run_device_full_tb(batch, praws, traws, n_live,
                        interpret: bool = False):
    """Device full fill + ON-DEVICE traceback: the band planes never
    leave the card; only final scores and compact (d_run, opcode)
    column records cross the link (~3 bytes/column vs 16*EBB
    bytes/column of raw planes). The walk is the column-scan
    reproduction of banded_backtrace_matrix_cutoff
    (bpm_banded.c:967-1036); see ops/banded_traceback_jax.py."""
    import jax

    from quicked_tpu.ops import banded_traceback_jax as btj
    from quicked_tpu.ops import banded_triton as bt

    args, statics = bt.stage(batch)
    out = bt.run_staged(args, statics, interpret)
    Bp = args[-1].shape[0]                  # padded lanes
    maxp = max((len(p) for p in praws), default=1)
    PP = max(32, 1 << max(maxp - 1, 1).bit_length())    # pow2 buckets
    praw_np, traw_np = btj.prep_raw_frames(praws, traws, statics["NB"] * W,
                                           PP, pad_to_b=Bp)

    def padv(a):
        v = np.zeros(Bp, np.int32)
        v[:a.shape[0]] = a
        return v

    ops = btj.traceback_ops_device(
        [out[k] for k in bt.MAT_NAMES], praw_np, traw_np, padv(batch.plen),
        padv(batch.tlen), padv(batch.prolog), EBB=statics["EBB"], n=n_live)
    scores_by_k = np.asarray(jax.device_get(out["scores_by_k"]))
    sc = extract_final_scores(batch, scores_by_k[:, :batch.B])
    return sc, ops


def _lane_pad(n_live: int, ebb_p2: int, min_lanes: int) -> int:
    """Padded lane count for a bucket. Shallow buckets keep the
    min_lanes floor (bounds XLA compile variants for the lane-vector
    kernels, where pad lanes are nearly free). Deep buckets skip it:
    they route to the host C kernel or the carry-scan, where every pad
    lane multiplies upload bytes and kernel work — padding a single
    long pair to 8 lanes is 8x the staging cost and flips the venue
    estimate to the host."""
    from quicked_tpu.aligner import lanes

    if lanes.is_deep(ebb_p2):
        return _next_pow2(n_live)
    return max(_next_pow2(n_live), min_lanes)


def _device_full_lane() -> bool:
    """Full (traceback) fills go to the device fill + on-device
    traceback when the device's score kernel is the Triton kernel (its
    FULL variant writes the planes the walk reads), the native library
    is there for cold shapes, and the measured link clears the records'
    readback (FULL_DEVICE_TB_MIN_MBPS, _MAX_DISPATCH_S)."""
    from quicked_tpu.aligner import lanes
    from quicked_tpu.ops.banded_native import native_available

    table = lanes.current()
    if ACTIVE_MESH is not None or table.score_kernel != "triton" or \
            not native_available():
        return False
    return (_device_readback_mbps() >= FULL_DEVICE_TB_MIN_MBPS
            and _device_dispatch_s() <= FULL_DEVICE_MAX_DISPATCH_S)


def banded_align_batch(patterns, texts, cutoffs, *, only_score: bool,
                       min_lanes: int = 8, raws=None):
    """BANDED algorithm over a batch, through the device kernels.

    Returns (scores int64 array, ops list of str|None). Semantics:
    run_banded driver (quicked.c:58-89) per pair, batched.

    Full (traceback) fills run on the device lane (_device_full_lane:
    the Triton full fill, then the traceback walked on the card) or
    through the per-pair host C fill+traceback.

    `raws`: optional (praws, traws) byte-string lists for pre-encoded
    inputs — the traceback M-vs-X test compares RAW chars, which the
    5-letter encoding collapses (see run_banded_full_native).
    """
    def _praw(i):
        return raws[0][i] if raws is not None \
            else _raw_bytes(patterns[i]).tobytes()

    def _traw(i):
        return raws[1][i] if raws is not None \
            else _raw_bytes(texts[i]).tobytes()

    n = len(patterns)
    device_full = False
    if not only_score:
        from quicked_tpu.ops.banded_native import (
            native_available,
            run_banded_full_native,
        )

        device_full = _device_full_lane()
        if not device_full and native_available() and ACTIVE_MESH is None:
            _venue("full_host_c")
            return run_banded_full_native(patterns, texts, cutoffs,
                                          raws=raws)
    scores = np.zeros(n, dtype=np.int64)
    ops_out: list = [None] * n
    plens = [len(p) for p in patterns]
    tlens = [len(t) for t in texts]
    keys = bucket_keys(plens, tlens, cutoffs, full=not only_score)

    by_key: dict = {}
    for i, k in enumerate(keys):
        by_key.setdefault(k, []).append(i)

    for (nb_p2, ebb_p2), idxs in by_key.items():
        if only_score:
            chunk = len(idxs)
        else:
            per_lane = nb_p2 * W * ebb_p2 * 16
            # the kernel allocates the PADDED lane count (pow2, floored
            # at min_lanes below) — chunk on a pow2 so the padding
            # cannot blow the budget it exists to enforce
            lanes_budget = max(FULL_FILL_BYTES_BUDGET // max(per_lane, 1),
                               1)
            chunk = 1 << (lanes_budget.bit_length() - 1)
            from quicked_tpu.ops.banded_triton import TILE_MIN
            if device_full and chunk < TILE_MIN:
                # Deep/long bucket: one kernel tile of traceback planes
                # would blow the byte budget the chunking enforces — the
                # per-pair host C fill+traceback is the right venue
                # (device_full implies native_available()).
                _venue("full_host_c")
                sc_nat, ops_nat = run_banded_full_native(
                    [patterns[i] for i in idxs],
                    [texts[i] for i in idxs],
                    [cutoffs[i] for i in idxs],
                    raws=([_praw(i) for i in idxs],
                          [_traw(i) for i in idxs]))
                for j, i in enumerate(idxs):
                    scores[i] = sc_nat[j]
                    ops_out[i] = ops_nat[j]
                continue
        for s in range(0, len(idxs), chunk):
            sub = idxs[s:s + chunk]
            pats = [patterns[i] for i in sub]
            txts = [texts[i] for i in sub]
            cos = [cutoffs[i] for i in sub]
            b_pad = _lane_pad(len(sub), ebb_p2, min_lanes)
            if not only_score:
                from quicked_tpu.utils import memreport
                memreport.record("FullFill.Planes",
                                 nb_p2 * W * ebb_p2 * 16 * b_pad)
            batch = prepare_banded_batch(
                pats, txts, cos, full=not only_score,
                pad_to_b=b_pad, min_nb=nb_p2, min_ebb=ebb_p2)
            if device_full:
                from quicked_tpu.utils import warmup

                praws = [_praw(i) for i in sub]
                traws = [_traw(i) for i in sub]
                key = ("full_triton_tb", batch.B, batch.EBB, batch.NB)
                if warmup.defer_cold(
                        key, lambda b=batch, pr=praws, tr=traws:
                        _run_device_full_tb(b, pr, tr, len(pr))):
                    # cold shape: per-pair host C fill+traceback now,
                    # device kernel compiles in the background
                    # (device_full implies native_available)
                    _venue("full_triton_tb_warming")
                    _venue("full_host_c")
                    sc_dev, ops_dev = run_banded_full_native(
                        pats, txts, cos, raws=(praws, traws))
                else:
                    _venue("full_triton_tb")
                    sc_dev, ops_dev = _run_device_full_tb(
                        batch, praws, traws, len(sub))
                    warmup.mark_warm(key)
                for j, i in enumerate(sub):
                    scores[i] = sc_dev[j]
                    ops_out[i] = ops_dev[j]
                continue
            out = _run_banded_auto(batch)
            sc = extract_final_scores(batch, out["scores_by_k"])
            for j, i in enumerate(sub):
                scores[i] = sc[j]
            if not only_score:
                ops = banded_traceback_batch(
                    out["mat_pv_lo"], out["mat_pv_hi"],
                    out["mat_mv_lo"], out["mat_mv_hi"],
                    list(range(len(sub))),
                    [_praw(i) for i in sub],
                    [_traw(i) for i in sub],
                    [int(batch.prolog[j]) for j in range(len(sub))])
                for j, i in enumerate(sub):
                    ops_out[i] = ops[j]
    return scores, ops_out


@dataclasses.dataclass
class BandedScoreState:
    """Per-pair band state in the kernels' native numpy form — consumed
    by myers_np.hirschberg_split_fast without per-element conversion."""

    score: int
    pv64: np.ndarray        # (ebb,) uint64 band words
    mv64: np.ndarray
    first: int
    last: int
    scores_k: np.ndarray    # (K+1,) shifted-row scores
    prolog: int
    geometry: myers_np.BandGeometry


def banded_score_results(patterns, texts, cutoffs, text_finish=None,
                         min_lanes: int = 8):
    """Score-only banded runs returning the full per-pair band state the
    Hirschberg driver consumes, through the device kernel.
    `text_finish` stops each lane at its midpoint while the band is
    sized for the full text (bpm_hirschberg.c:85-100)."""
    n = len(patterns)
    plens = [len(p) for p in patterns]
    tlens = [len(t) for t in texts]
    if text_finish is None:
        text_finish = tlens
    results: list = [None] * n

    # bucket on (pow2 processed-blocks, pow2 score-band width); keep
    # each pair's geometry so the result loop doesn't recompute it
    by_key: dict = {}
    geos: list = [None] * n
    for i in range(n):
        geos[i] = myers_np.band_geometry(plens[i], tlens[i],
                                         int(cutoffs[i]))
        ebb = myers_np.div_ceil(geos[i].cutoff, W) + 1
        nb = max(myers_np.div_ceil(int(text_finish[i]), W), 1)
        by_key.setdefault((_next_pow2(nb), _next_pow2(ebb)), []).append(i)

    for (nb_p2, ebb_p2), idxs in by_key.items():
        pats = [patterns[i] for i in idxs]
        txts = [texts[i] for i in idxs]
        cos = [cutoffs[i] for i in idxs]
        fins = [text_finish[i] for i in idxs]
        b_pad = _lane_pad(len(idxs), ebb_p2, min_lanes)
        batch = prepare_banded_batch(
            pats, txts, cos, full=False, text_finish=fins,
            pad_to_b=b_pad, min_nb=nb_p2, min_ebb=ebb_p2)
        from quicked_tpu.utils import memreport
        # the per-level band-plane readback the Hirschberg driver pays
        # (4 u32 planes x EBB x lanes) — the dominant transfer cost of
        # deep-band levels, made visible here
        memreport.record("Hirschberg.LevelPlanes",
                         batch.EBB * batch.B * 16)
        out = _run_banded_auto(batch)
        final_scores = extract_final_scores(batch, out["scores_by_k"])
        # one vectorised 64-bit reassembly + transpose for the batch;
        # per-pair rows are then contiguous views
        pv64 = np.ascontiguousarray(
            (out["pv_lo"].astype(np.uint64)
             | (out["pv_hi"].astype(np.uint64) << np.uint64(32))).T)
        mv64 = np.ascontiguousarray(
            (out["mv_lo"].astype(np.uint64)
             | (out["mv_hi"].astype(np.uint64) << np.uint64(32))).T)
        sck = np.ascontiguousarray(np.asarray(out["scores_by_k"]).T)
        for j, i in enumerate(idxs):
            results[i] = BandedScoreState(
                score=int(final_scores[j]), pv64=pv64[j], mv64=mv64[j],
                first=int(out["first"][j]), last=int(out["last"][j]),
                scores_k=sck[j], prolog=int(batch.prolog[j]),
                geometry=geos[i])
    return results


def _hsplit_fused(batch, interpret: bool = False):
    """Score kernel + on-device split epilogue over an interleaved
    fwd/rev level batch; returns 4 numpy vectors (pll, score_l,
    score_r, feasible) per task."""
    import jax
    import jax.numpy as jnp

    from quicked_tpu.ops import banded_triton as bt
    from quicked_tpu.ops.hirschberg_split_jax import (
        hsplit_epilogue_interleaved,
    )

    args, statics = bt.stage(batch)
    out = bt.run_staged(args, statics, interpret)
    Bp = args[-1].shape[0]

    def padv(a):
        v = np.zeros(Bp, np.int32)
        v[:a.shape[0]] = a
        return jnp.asarray(v)

    res = hsplit_epilogue_interleaved(
        *(out[k] for k in bt.OUT_NAMES), padv(batch.prolog),
        padv(batch.plen), padv(batch.tlen), EBB=statics["EBB"])
    n_tasks = batch.B // 2
    return [np.asarray(x)[:n_tasks] for x in jax.device_get(list(res))]


def hirschberg_level_splits_device(pats, txts, cos, mids, mids_r):
    """Device-fused Hirschberg split level: run the forward+reverse
    score passes AND the midpoint epilogue on device, reading back only
    O(tasks) split tuples — instead of per-level band planes
    (bpm_hirschberg.c:149-200's consumption, fused after the kernel).

    Returns a per-task list of (pll, score_l, score_r) | None, or None
    when the fused path doesn't apply (no Triton score kernel on this
    device, deep bands, host-preferred venue, or a cold shape warming
    in the background) — the caller then takes the banded_score_results +
    _level_splits path. Both paths are bit-exact with the spec."""
    from quicked_tpu.aligner import lanes

    on_mesh = ACTIVE_MESH is not None
    if not on_mesh and lanes.current().score_kernel != "triton":
        return None
    n = len(pats)
    by_key: dict = {}
    for i in range(n):
        geo = myers_np.band_geometry(len(pats[i]), len(txts[i]),
                                     int(cos[i]))
        ebb = myers_np.div_ceil(geo.cutoff, W) + 1
        nb = max(myers_np.div_ceil(max(int(mids[i]), int(mids_r[i])), W),
                 1)
        by_key.setdefault((_next_pow2(nb), _next_pow2(ebb)), []).append(i)
    results: list = [None] * n
    from quicked_tpu.utils import warmup

    # Two passes: stage + eligibility-check EVERY bucket first, run
    # kernels only when all buckets take the fused path. A mid-loop
    # decline (deep bucket, host venue, cold shape) after earlier
    # buckets already ran their kernels would discard those results,
    # re-run the level on the fallback path, and double-count the
    # hsplit venue (advisor, round 4). Checking first also enqueues
    # background warmups for ALL cold bucket shapes, not just the
    # first one hit.
    staged = []
    declined = False
    for (nb_p2, ebb_p2), idxs in by_key.items():
        if lanes.is_deep(ebb_p2):
            return None     # deep bands are not the fused kernel's
        m = len(idxs)
        pats_il, txts_il, cos_il, fins_il = [], [], [], []
        for i in idxs:
            # interleaved halves: task j -> lanes 2j (fwd), 2j+1 (rev),
            # so both halves co-locate on one shard under lane sharding
            pats_il += [pats[i], pats[i][::-1]]
            txts_il += [txts[i], txts[i][::-1]]
            cos_il += [int(cos[i])] * 2
            fins_il += [int(mids[i]), int(mids_r[i])]
        b_pad = _lane_pad(2 * m, ebb_p2, 8)
        if on_mesh:
            b_pad = max(b_pad, 2 * int(ACTIVE_MESH.devices.size))
        batch = prepare_banded_batch(
            pats_il, txts_il, cos_il, full=False, text_finish=fins_il,
            pad_to_b=b_pad, min_nb=nb_p2, min_ebb=ebb_p2)
        if not on_mesh:
            from quicked_tpu.ops.banded_native import (
                native_available as _host_ok,
            )
            if _host_ok() and batch.enc_patterns is not None and \
                    _prefer_host_shallow(batch, 2 * m):
                return None        # host venue wins this level's passes
            key = ("hsplit_fused", batch.B, batch.EBB, batch.NB)
            if warmup.defer_cold(key, lambda b=batch: _hsplit_fused(b)):
                declined = True    # cold shape: numpy path this time
                continue
        staged.append((idxs, batch))
    if declined:
        return None
    for idxs, batch in staged:
        if on_mesh:
            from quicked_tpu.parallel.mesh import run_level_splits_sharded
            _venue("hsplit_mesh")
            pll, sl, sr, ok = run_level_splits_sharded(batch, ACTIVE_MESH)
        else:
            _venue("hsplit_device")
            pll, sl, sr, ok = _hsplit_fused(batch)
            warmup.mark_warm(("hsplit_fused", batch.B, batch.EBB,
                              batch.NB))
        for j, i in enumerate(idxs):
            results[i] = ((int(pll[j]), int(sl[j]), int(sr[j]))
                          if ok[j] else None)
    return results


def _finish(status, score, ops, only_score):
    """extract_results semantics (quicked.c:34-56): only_score keeps
    the cigar NULL for every algorithm."""
    if int(status) < 0:
        return status, -1, None
    if only_score:
        if ops is None:
            return status, int(score), None
        return status, Cigar(operations=ops).score_edit(), None
    cig = Cigar(operations=ops or "")
    return status, cig.score_edit(), (cig.sprint(True) if ops else None)


def align_batch_full(pairs, params: QuickedParams | None = None) -> BatchResult:
    """Align a batch of (pattern, text) pairs; returns results in order."""
    params = params or QuickedParams()
    from quicked_tpu import native
    native.set_force_scalar(params.force_scalar)
    n = len(pairs)
    statuses: list = [QuickedStatus.QUICKED_OK] * n
    scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n

    live = []
    for i, (p, t) in enumerate(pairs):
        if len(p) == 0 or len(t) == 0:
            statuses[i] = QuickedStatus.QUICKED_EMPTY_SEQUENCE
        else:
            live.append(i)
    if not live:
        return BatchResult(statuses, scores, cigars)

    algo = params.algo
    if algo == QuickedAlgo.BANDED and params.use_kernels:
        pats = [pairs[i][0] for i in live]
        txts = [pairs[i][1] for i in live]
        cos = [max(len(pairs[i][0]), len(pairs[i][1])) * params.bandwidth // 100
               for i in live]
        sc, ops = banded_align_batch(pats, txts, cos,
                                     only_score=params.only_score)
        for j, i in enumerate(live):
            st, s, c = _finish(QuickedStatus.QUICKED_WIP, sc[j], ops[j],
                               params.only_score)
            statuses[i], scores[i], cigars[i] = st, s, c
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.WINDOWED and params.use_kernels:
        from quicked_tpu.aligner.cascade import (windowed_full_batch,
                                                 windowed_score_batch)
        pats = [pairs[i][0] for i in live]
        txts = [pairs[i][1] for i in live]
        if params.only_score:
            sc, _ = windowed_score_batch(pats, txts, 0,
                                         params.window_size,
                                         params.overlap_size)
            for j, i in enumerate(live):
                st, s, c = _finish(QuickedStatus.QUICKED_WIP, sc[j], None,
                                   True)
                statuses[i], scores[i], cigars[i] = st, s, c
        else:
            ops = windowed_full_batch(pats, txts, params.window_size,
                                      params.overlap_size)
            for j, i in enumerate(live):
                st, s, c = _finish(QuickedStatus.QUICKED_WIP, None, ops[j],
                                   False)
                statuses[i], scores[i], cigars[i] = st, s, c
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.HIRSCHBERG and params.use_kernels:
        from quicked_tpu.aligner.hirschberg import hirschberg_batch
        pats = [pairs[i][0] for i in live]
        txts = [pairs[i][1] for i in live]
        cos = [max(len(p), len(t)) * params.bandwidth // 100
               for p, t in zip(pats, txts)]
        res = hirschberg_batch(txts, pats, cos)
        for j, i in enumerate(live):
            st, ops = res[j]
            if int(st) < 0:
                # extract_results still runs on failure (quicked.c:
                # 154-157): report the partial right-side CIGAR and its
                # score alongside the error status
                c = Cigar(operations=ops or "")
                statuses[i] = st
                scores[i] = c.score_edit()
                cigars[i] = (c.sprint(True)
                             if ops and not params.only_score else None)
            else:
                st2, s, c = _finish(st, None, ops, params.only_score)
                statuses[i], scores[i], cigars[i] = st2, s, c
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.QUICKED and params.use_kernels:
        from quicked_tpu.aligner.cascade import quicked_cascade_batch
        res = quicked_cascade_batch([pairs[i] for i in live], params)
        for j, i in enumerate(live):
            statuses[i] = res.status[j]
            scores[i] = res.score[j]
            # extract_results: only_score keeps the cigar NULL
            # (quicked.c:38-42); the score is already the edit score
            cigars[i] = None if params.only_score else res.cigar[j]
        return BatchResult(statuses, scores, cigars)

    # Remaining algorithms: exact numpy semantic model per pair (replaced
    # by batched kernels as they land).
    from quicked_tpu.api import _align_one_np
    for i in live:
        p, t = pairs[i]
        st, s, c = _align_one_np(p, t, params.replace(use_kernels=False))
        statuses[i], scores[i], cigars[i] = st, s, (c if c else None)
    return BatchResult(statuses, scores, cigars)
