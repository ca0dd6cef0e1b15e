"""Batched QuickEd bound-and-align cascade (the flagship algorithm).

Batched re-expression of run_quicked (quicked.c:163-306): because the
4-stage cascade is data-dependent per pair, the batch is *re-partitioned*
between stages (SURVEY.md §7) — stage 1 runs on everything, later stages
only on the pairs their predicates select, each through the batched
device kernels:

  stage 1: WindowEd(ws=2, ovl=1) score bound            (quicked.c:184-199)
  stage 2: WindowEd(ws=W, ovl) forward + reversed-pair  (quicked.c:204-235)
  stage 3: BandEd score-only, telescoping retry loop    (quicked.c:237-276)
  stage 4: Hirschberg full alignment under the bound    (quicked.c:290)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from quicked_tpu.cigar import Cigar
from quicked_tpu.ops.windowed_jax import (
    prepare_windowed_batch,
    run_windowed_full,
    run_windowed_score,
)
from quicked_tpu.params import QuickedParams, QuickedStatus

W = 64


@dataclasses.dataclass
class CascadeResult:
    status: list
    score: np.ndarray
    cigar: list


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _raw(s, enc) -> bytes:
    """Raw byte view for the C kernels: the original ascii chars, or
    the encoded array itself when the caller passed pre-encoded input
    (enc equality is then the M-vs-X contract)."""
    if isinstance(s, np.ndarray):
        return np.asarray(enc, dtype=np.uint8).tobytes()
    return s.encode("ascii", "replace")


# Above this length, the windowed walk has enough sequential window
# steps (~len/64 while-iterations of narrow ops) that the per-iteration
# overhead of a device loop dominates: those buckets take the host C
# kernel when the native library is there. (Without it they run on the
# default device: on an H100 a 16 x 16384 bucket ran in 0.217 s there
# against 0.281 s on the CPU backend.)
WINDOWED_CPU_MIN_LEN = 8192


def _windowed_native_batch(patterns, texts, hew_threshold, window_size,
                           overlap_size):
    """CPU path: per-pair C windowed kernel, threaded over lanes."""
    from quicked_tpu import dna, native
    from quicked_tpu.utils.host_threads import map_lanes

    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    hews = np.zeros(n, dtype=np.int64)

    def one(i):
        p, t = patterns[i], texts[i]
        pe = p if isinstance(p, np.ndarray) else dna.encode(p)
        te = t if isinstance(t, np.ndarray) else dna.encode(t)
        scores[i], hews[i] = native.windowed_score(
            pe, _raw(p, pe), te, _raw(t, te), window_size, overlap_size,
            hew_threshold)

    map_lanes(one, n)
    return scores, hews


def windowed_score_batch(patterns, texts, hew_threshold: int,
                         window_size: int, overlap_size: int,
                         min_lanes: int = 8):
    """Bucketed batched windowed score bound. Returns (score, hew) i64.

    Routing: the C kernel serves CPU platforms entirely and, on
    accelerators, the long-read buckets (the window walk is a long
    sequential loop of narrow ops — accelerator-hostile); short-read
    buckets batch onto the device kernel."""
    from quicked_tpu import native
    from quicked_tpu.aligner import batch as ab
    from quicked_tpu.aligner import lanes

    n = len(patterns)
    mesh = ab.ACTIVE_MESH
    # Under a mesh the device buckets run sharded, but the LONG-READ
    # native routing below stays: the window walk is scalar-sequential
    # and meshing it would run the long device loop on every card
    # instead of the host walk.
    use_native = native.available() and window_size <= 16
    if use_native and lanes.current().host_first and mesh is None:
        return _windowed_native_batch(patterns, texts, hew_threshold,
                                      window_size, overlap_size)
    scores = np.zeros(n, dtype=np.int64)
    hews = np.zeros(n, dtype=np.int64)
    cols = W * window_size
    by_key: dict = {}
    for i in range(n):
        key = _next_pow2(max(len(patterns[i]), len(texts[i]), cols))
        by_key.setdefault(key, []).append(i)
    for size, idxs in by_key.items():
        pats = [patterns[i] for i in idxs]
        txts = [texts[i] for i in idxs]
        if use_native and size >= WINDOWED_CPU_MIN_LEN:
            sc, hw = _windowed_native_batch(pats, txts, hew_threshold,
                                            window_size, overlap_size)
        else:
            b_pad = max(_next_pow2(len(idxs)), min_lanes)
            if mesh is not None:        # lanes must divide the mesh
                nd = mesh.devices.size
                b_pad = ((b_pad + nd - 1) // nd) * nd
            batch = prepare_windowed_batch(
                pats, txts, window_size=window_size, pad_to_b=b_pad,
                min_t=size, min_p=size, min_kp=size // W + 1)
            if mesh is not None:
                from quicked_tpu.parallel.mesh import run_windowed_sharded
                sc, hw = run_windowed_sharded(batch, hew_threshold,
                                              window_size, overlap_size,
                                              mesh)
            else:
                from quicked_tpu.utils import warmup
                key = ("windowed", window_size, overlap_size,
                       hew_threshold, size, b_pad)

                def _dev(b=batch):
                    return run_windowed_score(
                        b, hew_threshold, window_size, overlap_size)

                if use_native and warmup.defer_cold(key, _dev):
                    # cold shape: host C kernel now, device kernel
                    # compiles in the background (utils/warmup)
                    ab._venue("windowed_warming")
                    sc, hw = _windowed_native_batch(
                        pats, txts, hew_threshold, window_size,
                        overlap_size)
                else:
                    sc, hw = _dev()
                    warmup.mark_warm(key)
        for j, i in enumerate(idxs):
            scores[i] = sc[j]
            hews[i] = hw[j]
    return scores, hews


def windowed_full_batch(patterns, texts, window_size: int,
                        overlap_size: int, min_lanes: int = 8) -> list:
    """Bucketed batched full-CIGAR windowed alignment; returns op
    strings in input order."""
    from quicked_tpu import dna, native
    from quicked_tpu.aligner import lanes

    n = len(patterns)
    if window_size <= 16 and native.available() and \
            lanes.current().host_first:
        out = []
        for p, t in zip(patterns, texts):
            pe = p if isinstance(p, np.ndarray) else dna.encode(p)
            te = t if isinstance(t, np.ndarray) else dna.encode(t)
            out.append(native.windowed_full(pe, _raw(p, pe), te, _raw(t, te),
                                            window_size, overlap_size))
        return out
    out = [None] * n
    cols = W * window_size
    by_key: dict = {}
    for i in range(n):
        key = _next_pow2(max(len(patterns[i]), len(texts[i]), cols))
        by_key.setdefault(key, []).append(i)
    for size, idxs in by_key.items():
        pats = [patterns[i] for i in idxs]
        txts = [texts[i] for i in idxs]
        b_pad = max(_next_pow2(len(idxs)), min_lanes)
        batch = prepare_windowed_batch(
            pats, txts, window_size=window_size, pad_to_b=b_pad,
            min_t=size, min_p=size, min_kp=size // W + 1)
        ops = run_windowed_full(batch, window_size, overlap_size)
        for j, i in enumerate(idxs):
            out[i] = ops[j]
    return out


# Pairs at or below _native_fast_max() run the whole cascade through
# the one-call native batch lane on every platform: beyond that length
# the native lane defers stage 4 to the batched (device-backed)
# Hirschberg driver anyway, and the staged lane's device score kernels
# take over.
NATIVE_CASCADE_MAX_LEN = None   # None -> derived from bandwidth/budget


_FAST_MAX_CACHE: dict = {}


def _native_fast_max(bandwidth: int) -> int:
    """Largest pair length whose worst-case stage-4 banded footprint
    (ebb * text_len * 8 * 2, bpm_hirschberg.c:63-65) fits the 16 MB
    Hirschberg base-case budget — ~20 kbp at the default 15% band.
    Memoized on (bandwidth, budget): the bisection ran on every
    cascade call (~15 us, visible on the single-pair API path); the
    budget stays in the key so tests that monkeypatch it are honest."""
    from quicked_tpu.params import HIRSCHBERG_BUFFER_SIZE

    key = (bandwidth, HIRSCHBERG_BUFFER_SIZE)
    got = _FAST_MAX_CACHE.get(key)
    if got is not None:
        return got

    def fits(L: int) -> bool:
        ebb = (L * bandwidth // 100) // W + 2
        return ebb * L * 16 <= HIRSCHBERG_BUFFER_SIZE

    lo, hi = W, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    _FAST_MAX_CACHE[key] = lo
    return lo


def _prefer_staged_short() -> bool:
    """True when short pairs are forced through the staged device
    cascade (QUICKED_TPU_STAGED_SHORT=1) instead of the native C lane."""
    return os.environ.get("QUICKED_TPU_STAGED_SHORT") == "1"


def quicked_cascade_batch(pairs, params: QuickedParams | None = None,
                          timers=None) -> CascadeResult:
    """Run the QuickEd cascade on a batch of (pattern, text) pairs.

    `timers` (utils.profiler.PhaseTimers) mirrors the reference's
    per-stage instrumentation (quicked.c:184-294).

    Routing: a native one-call batch lane (qh_quicked_batch: all four
    stages in C, threads inside) serves every pair on the CPU and the
    short pairs on the GPU; the staged device-kernel lane serves the
    rest. Native-lane pairs whose stage-4 footprint exceeds
    the Hirschberg budget come back with their proven bound and finish
    through the batched Hirschberg driver.
    """
    params = params or QuickedParams()
    if timers is None:
        from quicked_tpu.utils.profiler import PhaseTimers
        timers = PhaseTimers()
    n = len(pairs)

    from quicked_tpu import native
    native.set_force_scalar(params.force_scalar)
    import os as _os
    env = _os.environ.get("QUICKED_TPU_NATIVE_CASCADE_MAX_LEN")
    if env is not None:
        fast_max = int(env)
    elif NATIVE_CASCADE_MAX_LEN is not None:
        fast_max = NATIVE_CASCADE_MAX_LEN
    else:
        fast_max = _native_fast_max(params.bandwidth)
    from quicked_tpu.aligner import batch as _ab
    if _ab.ACTIVE_MESH is not None:
        # meshed execution: everything through the sharded device lane
        fast = []
    elif native.available() and params.window_size <= 16:
        from quicked_tpu.aligner import lanes
        if lanes.current().host_first:
            fast = list(range(n))
        else:
            # length scan via map(len)/numpy: a per-pair Python
            # max(len, len) loop costs ~0.2 s on a 100k-pair batch
            flat = [s for pair in pairs for s in pair]
            lens = np.fromiter(map(len, flat), np.int64, 2 * n)
            maxlens = np.maximum(lens[0::2], lens[1::2])
            if n and int(maxlens.max()) <= fast_max:
                fast = list(range(n))
            else:
                fast = np.nonzero(maxlens <= fast_max)[0].tolist()
            if fast and _prefer_staged_short():
                _ab._venue("cascade_staged_shortreads")
                fast = []
    else:
        fast = []
    # One total-timer lap per batch call regardless of lane routing (a
    # mixed fast/slow batch runs BOTH lanes; each lane timing its own
    # total would record two laps per call and split the printed mean)
    timers.total.start()
    try:
        if fast:
            return _cascade_with_native_lane(pairs, params, timers, fast)
        return _cascade_staged(pairs, params, timers)
    finally:
        timers.total.stop()


def _cascade_with_native_lane(pairs, params, timers, fast) -> CascadeResult:
    from quicked_tpu import native
    from quicked_tpu.aligner.hirschberg import hirschberg_batch
    from quicked_tpu.params import HIRSCHBERG_BUFFER_SIZE

    n = len(pairs)
    fast_set = set(fast)
    slow = [i for i in range(n) if i not in fast_set]

    statuses: list = [None] * n
    scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n

    from quicked_tpu.aligner.batch import _venue
    _venue("cascade_native")
    all_fast = len(fast) == n
    if all_fast:
        f_pats = [p for p, _ in pairs]
        f_txts = [t for _, t in pairs]
    else:
        f_pats = [pairs[i][0] for i in fast]
        f_txts = [pairs[i][1] for i in fast]
    st, sc, rles = native.quicked_batch(
        f_pats, f_txts,
        bandwidth=params.bandwidth, window_size=params.window_size,
        overlap_size=params.overlap_size,
        hew_threshold=params.hew_threshold,
        hew_percentage=params.hew_percentage,
        budget=HIRSCHBERG_BUFFER_SIZE, rle=True)
    if all_fast and not np.any(st):
        # the hot batch shape: every pair aligned fully in C — return
        # the packed results without materializing n Python strings
        # (run_quicked returns QUICKED_WIP on success, quicked.c:305)
        return CascadeResult(status=[QuickedStatus.QUICKED_WIP] * n,
                             score=sc, cigar=rles.with_empty_as_none())
    deferred = []       # (input index, proven bound)
    for j, i in enumerate(fast):
        if st[j] == 0:
            # run_quicked returns QUICKED_WIP on success (quicked.c:305)
            statuses[i] = QuickedStatus.QUICKED_WIP
            scores[i] = sc[j]
            cigars[i] = rles[j] if rles[j] else None
        else:
            deferred.append((i, int(sc[j])))
    if deferred:
        # stage-4 work: book it under the align timer like the staged
        # lane does, so per-stage instrumentation stays comparable
        timers.align.start()
        res = hirschberg_batch([pairs[i][1] for i, _ in deferred],
                               [pairs[i][0] for i, _ in deferred],
                               [b for _, b in deferred])
        for (i, _), (h_st, h_ops) in zip(deferred, res):
            # run_quicked ignores the Hirschberg status and returns WIP
            # (quicked.c:290-305)
            statuses[i] = QuickedStatus.QUICKED_WIP
            c = Cigar(operations=h_ops or "")
            scores[i] = c.score_edit()
            cigars[i] = c.sprint(True) if h_ops else None
        timers.align.stop()

    if slow:
        sub = _cascade_staged([pairs[i] for i in slow], params, timers)
        for j, i in enumerate(slow):
            statuses[i] = sub.status[j]
            scores[i] = sub.score[j]
            cigars[i] = sub.cigar[j]
    return CascadeResult(status=statuses, score=scores, cigar=cigars)


def _cascade_staged(pairs, params: QuickedParams, timers) -> CascadeResult:
    """The staged batch-repartitioning cascade over the device kernels."""
    n = len(pairs)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    max_len = np.array([max(len(p), len(t)) for p, t in pairs],
                       dtype=np.int64)

    from quicked_tpu.aligner.batch import banded_align_batch
    from quicked_tpu.aligner.hirschberg import hirschberg_batch

    # ---- STAGE 1: fast windowed bound (quicked.c:184-199) ----
    timers.windowed_s.start()
    score, hew = windowed_score_batch(pats, txts, params.hew_threshold[0],
                                      2, 1)
    timers.windowed_s.stop()
    hard = [i for i in range(n)
            if hew[i] * W > max_len[i] * params.hew_percentage[0] // 100]

    if hard:
        # ---- STAGE 2: large windows, forward + reversed pair ----
        ws, ovl = params.window_size, params.overlap_size
        timers.windowed_l.start()
        s_fwd, hew_fwd = windowed_score_batch(
            [pats[i] for i in hard], [txts[i] for i in hard],
            params.hew_threshold[1], ws, ovl)
        s_rev, hew_rev = windowed_score_batch(
            [pats[i][::-1] for i in hard], [txts[i][::-1] for i in hard],
            params.hew_threshold[1], ws, ovl)
        timers.windowed_l.stop()
        harder = []
        for j, i in enumerate(hard):
            sc = min(s_fwd[j], s_rev[j])
            hw = hew_fwd[j]
            if sc >= s_rev[j]:
                hw = hew_rev[j]
            score[i] = sc
            if hw * W * (ws - ovl) > max_len[i] * params.hew_percentage[1] // 100:
                harder.append(i)

        if harder:
            # ---- STAGE 3: banded score-only + telescoping retry
            # (quicked.c:246-276) ----
            timers.banded.start()
            cut = {i: int(min(max_len[i] * params.bandwidth // 100, score[i]))
                   for i in harder}
            # Narrow-band trial (same as qh_quicked_one's): a banded
            # score <= its cutoff is provably exact, so a 5/8 band
            # resolves cap-limited pairs at ~5/8 the cost; failures
            # fall into the untouched reference retry schedule below.
            # Outputs stay byte-identical (the accepted score equals
            # the wider band's). Cap-limited only (ws bound > bw cap):
            # on uniform noise the bound is near-tight and a trial
            # would almost always miss (measured true/cut ~ 1.0).
            if os.environ.get("QUICKED_TPU_NO_BAND_TRIAL") != "1":
                trial = [i for i in harder
                         if score[i] > cut[i] and cut[i] >= 4096
                         and cut[i] * 5 // 8
                         > abs(len(pats[i]) - len(txts[i])) + 1]
                if trial:
                    tcut = [cut[i] * 5 // 8 for i in trial]
                    ts, _ = banded_align_batch(
                        [pats[i] for i in trial], [txts[i] for i in trial],
                        tcut, only_score=True)
                    accepted = set()
                    for j, i in enumerate(trial):
                        s = int(ts[j])
                        if 0 <= s <= tcut[j]:
                            score[i] = s
                            accepted.add(i)
                    harder = [i for i in harder if i not in accepted]
            pending = list(harder)
            while pending:
                ns, _ = banded_align_batch(
                    [pats[i] for i in pending], [txts[i] for i in pending],
                    [cut[i] for i in pending], only_score=True)
                nxt = []
                for j, i in enumerate(pending):
                    new_score = int(ns[j])
                    if (new_score > max_len[i] // 4
                            and cut[i] * 3 // 2 < new_score) or new_score < 0:
                        # floor at 1: a zero cut (tiny max_len * small
                        # bandwidth) would double to zero forever
                        cut[i] = max(cut[i] * 2, 1)
                        nxt.append(i)
                    else:
                        score[i] = new_score
                pending = nxt
            timers.banded.stop()

    # ---- STAGE 4: full alignment under the proven bound ----
    timers.align.start()
    res = hirschberg_batch(txts, pats, [int(s) for s in score])
    timers.align.stop()

    statuses: list = [None] * n
    final_scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n
    for i, (st, ops) in enumerate(res):
        # run_quicked ignores the Hirschberg status and extracts whatever
        # (possibly partial) CIGAR is in the shared buffer, returning WIP
        # (quicked.c:290-305) — non-convergence is not an error here.
        statuses[i] = QuickedStatus.QUICKED_WIP
        c = Cigar(operations=ops or "")
        final_scores[i] = c.score_edit()
        cigars[i] = c.sprint(True) if ops else None
    return CascadeResult(status=statuses, score=final_scores, cigar=cigars)
