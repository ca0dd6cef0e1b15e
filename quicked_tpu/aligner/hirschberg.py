"""Batched Hirschberg driver over the device banded kernels.

Batched re-expression of bpm_compute_matrix_hirschberg
(bpm_hirschberg.c:33-270): instead of per-pair recursion, a host-side
worklist processes all pairs' subproblems level by level — base cases
(band footprint <= 16 MB, bpm_hirschberg.c:63-65) run batched through the
full banded kernel + traceback, splits run batched forward/reverse
score-only passes, and midpoints are computed on host from the returned
band state (myers_np.hirschberg_split). Leaf CIGARs are assembled
left-to-right by their recursion path.

Failure semantics match the reference's shared right-to-left output
buffer (bpm_hirschberg.c:210-243): the recursion solves the RIGHT half
before the left, so when a split fails with QUICKED_FAIL_NON_CONVERGENCE
the buffer already holds every leaf to the right of the (DFS-first)
failing node — and quicked.c extracts those partial results regardless
of status (quicked.c:299, 154-157). The worklist reproduces this by
continuing the right-of-failure subtree and discarding left-side leaves.
"""

from __future__ import annotations

import numpy as np

from quicked_tpu.ops import myers_np
from quicked_tpu.params import HIRSCHBERG_BUFFER_SIZE, QuickedStatus


# Below this many split tasks the per-pair numpy split is cheaper than
# assembling padded planes + a jit dispatch; above it the batched
# epilogue op amortizes (one call per level instead of a Python loop)
# — many-lane levels appear in the distributed/mixed-stream workloads.
# A long pair's levels (<= 16 tasks) cost ~1 ms/task on the numpy path
# vs a per-geometry XLA compile of seconds plus dispatch for the
# batched op, so the op pays off only on wide levels.
_SPLIT_BATCH_MIN = 64


def _splits_np(split, fwd, rev):
    """Per-pair spec-path midpoints (the batched op's bit-exact twin)."""
    return [myers_np.hirschberg_split_fast(
        f.pv64, f.mv64, f.first, f.last, f.scores_k,
        r.pv64, r.mv64, r.first, r.last, r.scores_k,
        f.prolog, len(t[3]), len(t[2]))
        for t, f, r in zip(split, fwd, rev)]


def _level_splits(split, fwd, rev):
    """Per-task midpoints for one worklist level: (pll, score_l,
    score_r) or None per task. Small levels take the per-pair spec
    path; large ones the batched op (ops/hirschberg_split_jax),
    bit-exact with it by construction and by test."""
    if len(split) < _SPLIT_BATCH_MIN:
        return _splits_np(split, fwd, rev)
    import numpy as np

    from quicked_tpu.ops.hirschberg_split_jax import hirschberg_split_batch

    # Shared pow2 buckets for EVERY traced dimension (EBB, the lane
    # count B, and the score-window length K1): the worklist's size and
    # geometry change every level, and an un-bucketed call would pay
    # one XLA compile per level — more than the per-pair numpy path it
    # replaces. Pad lanes replicate lane 0's state and are dropped on
    # return (the repo-wide _prep/_lane_pad pattern).
    B = len(split)
    B_pad = max(1 << max(B - 1, 0).bit_length(), _SPLIT_BATCH_MIN)
    EBB = 1 << max(max(len(f.pv64) for f in fwd) - 1, 0).bit_length()
    K1 = max(max(len(f.scores_k) for f in fwd),
             max(len(r.scores_k) for r in rev))
    K1 = 1 << max(K1 - 1, 0).bit_length()

    def planes(states):
        pv_lo = np.zeros((EBB, B_pad), np.uint32)
        pv_hi = np.zeros((EBB, B_pad), np.uint32)
        mv_lo = np.zeros((EBB, B_pad), np.uint32)
        mv_hi = np.zeros((EBB, B_pad), np.uint32)
        scores = np.zeros((K1, B_pad), np.int32)
        for j, st in enumerate(states):
            e = len(st.pv64)
            pv_lo[:e, j] = (st.pv64 & np.uint64(0xFFFFFFFF)) \
                .astype(np.uint32)
            pv_hi[:e, j] = (st.pv64 >> np.uint64(32)).astype(np.uint32)
            mv_lo[:e, j] = (st.mv64 & np.uint64(0xFFFFFFFF)) \
                .astype(np.uint32)
            mv_hi[:e, j] = (st.mv64 >> np.uint64(32)).astype(np.uint32)
            sk = np.asarray(st.scores_k, np.int64)
            scores[:len(sk), j] = sk[:K1]
            # rows past the kernel's window: the init formula — equals
            # the spec's out-of-dict fallback in the shifted frame
            k = np.arange(len(sk), K1)
            scores[len(sk):, j] = (k - st.prolog + 1) * 64
        for j in range(len(states), B_pad):    # pad lanes: lane 0 copy
            pv_lo[:, j] = pv_lo[:, 0]
            pv_hi[:, j] = pv_hi[:, 0]
            mv_lo[:, j] = mv_lo[:, 0]
            mv_hi[:, j] = mv_hi[:, 0]
            scores[:, j] = scores[:, 0]
        return pv_lo, pv_hi, mv_lo, mv_hi, scores

    # Cold geometries defer to the spec-path numpy loop while the op
    # compiles in the background (utils/warmup); both paths are
    # bit-exact.
    from quicked_tpu.utils import warmup

    key = ("hsplit", B_pad, EBB, K1)

    def _dev_call(args_np, EBB=EBB):
        return hirschberg_split_batch(*args_np, EBB=EBB)

    def i32(xs, pad0):
        xs = list(xs)
        xs += [xs[0] if xs else pad0] * (B_pad - len(xs))
        return np.asarray(xs, np.int32)

    fp, rp = planes(fwd), planes(rev)
    args_np = (
        *fp[:4], i32([f.first for f in fwd], 0),
        i32([f.last for f in fwd], 0), fp[4],
        *rp[:4], i32([r.first for r in rev], 0),
        i32([r.last for r in rev], 0), rp[4],
        i32([f.prolog for f in fwd], 0),
        i32([len(f.pv64) for f in fwd], 1),
        i32([len(t[3]) for t in split], 1),
        i32([len(t[2]) for t in split], 1))
    if warmup.defer_cold(key, lambda: _dev_call(args_np)):
        return _splits_np(split, fwd, rev)
    pll, sl, sr, ok = _dev_call(args_np)
    pll, sl, sr, ok = (np.asarray(pll), np.asarray(sl), np.asarray(sr),
                       np.asarray(ok))
    return [(int(pll[j]), int(sl[j]), int(sr[j])) if ok[j] else None
            for j in range(len(split))]


def hirschberg_batch(texts, patterns, cutoffs):
    """Full alignment of each (text, pattern) under its score bound.

    Returns list of (status, ops_str) in input order. On
    QUICKED_FAIL_NON_CONVERGENCE, ops_str holds the partial right-side
    alignment the reference would leave in its output buffer (possibly
    empty).
    """
    n = len(texts)
    leaves: list[list] = [[] for _ in range(n)]
    status = [QuickedStatus.QUICKED_OK] * n
    # Rightmost failing path per pair. The reference's DFS (right half
    # first) aborts at the lexicographically greatest failing node; only
    # leaves strictly right of it were written before the abort.
    fail_path: dict[int, tuple] = {}

    def _enc_raw(s):
        # Encode ONCE per pair; levels slice the array (zero-copy
        # views) instead of re-encoding string slices every level —
        # the per-level dna.encode of 2x half-length strings was a
        # measured ~20% of workload-4's Hirschberg wall. Raw bytes ride
        # along for the base-case traceback's M-vs-X raw-char test.
        if isinstance(s, np.ndarray):
            e = np.asarray(s, np.uint8)
            return e, e.tobytes()
        from quicked_tpu import dna
        return dna.encode(s), s.encode("ascii", "replace")

    # task: (pair, path, text, pattern, cutoff, traw, praw); text/
    # pattern are encoded uint8 views, traw/praw the matching raw
    # bytes. path is the 0/1 left/right descent — leaves are
    # prefix-free, so lexicographic path order is left-to-right CIGAR
    # order.
    tasks = []
    for i in range(n):
        te, tr = _enc_raw(texts[i])
        pe, pr = _enc_raw(patterns[i])
        tasks.append((i, (), te, pe, int(cutoffs[i]), tr, pr))

    from quicked_tpu.aligner.batch import (banded_align_batch,
                                           banded_score_results)

    while tasks:
        base, split = [], []
        for t in tasks:
            i, path, text, pattern, cutoff = t[:5]
            if i in fail_path and path < fail_path[i]:
                # left of the failure: the reference never visits it
                continue
            geo = myers_np.band_geometry(len(pattern), len(text), cutoff)
            if geo.ebb * len(text) * 8 * 2 <= HIRSCHBERG_BUFFER_SIZE:
                base.append(t)
            else:
                split.append(t)

        if base:
            _, ops = banded_align_batch(
                [t[3] for t in base], [t[2] for t in base],
                [t[4] for t in base], only_score=False,
                raws=([t[6] for t in base], [t[5] for t in base]))
            for t, op in zip(base, ops):
                leaves[t[0]].append((t[1], op))

        tasks = []
        if split:
            pats = [t[3] for t in split]
            txts = [t[2] for t in split]
            cos = [t[4] for t in split]
            mids = [(len(t[2]) + 1) // 2 for t in split]
            mids_r = [len(t[2]) - m for t, m in zip(split, mids)]
            # Device-routed levels fuse the split epilogue after the
            # score kernel and read back O(tasks) tuples instead of
            # band planes (batch.hirschberg_level_splits_device); when
            # that path declines (CPU host, deep bands, host venue,
            # cold shape) fall back to the band-state flow below.
            from quicked_tpu.aligner.batch import (
                hirschberg_level_splits_device,
            )
            splits = hirschberg_level_splits_device(pats, txts, cos,
                                                    mids, mids_r)
            if splits is None:
                # the forward and reverse half passes are independent
                # and share geometry, so they merge into ONE score
                # batch: a single kernel dispatch per level (halves the
                # per-level dispatch+upload cost on device venues), and
                # on the host venue the native batch kernel splits its
                # thread pool across the 2N lanes itself (intra =
                # threads/lanes, bpm_hirschberg.c:84-100's concurrency
                # without oversubscription)
                both = banded_score_results(
                    pats + [p[::-1] for p in pats],
                    txts + [t[::-1] for t in txts],
                    cos + cos, text_finish=mids + mids_r)
                fwd, rev = both[:len(split)], both[len(split):]
                splits = _level_splits(split, fwd, rev)
            for t, mid, sp in zip(split, mids, splits):
                i, path, text, pattern, cutoff, traw, praw = t
                if sp is None:
                    status[i] = QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE
                    if path >= fail_path.get(i, path):
                        fail_path[i] = path
                    continue
                pll, score_l, score_r = sp
                tasks.append((i, path + (0,), text[:mid], pattern[:pll],
                              int(score_l), traw[:mid], praw[:pll]))
                tasks.append((i, path + (1,), text[mid:], pattern[pll:],
                              int(score_r), traw[mid:], praw[pll:]))

    out = []
    for i in range(n):
        if status[i] != QuickedStatus.QUICKED_OK:
            fp = fail_path.get(i, ())
            kept = [(p, op) for p, op in leaves[i] if p > fp]
            out.append((status[i],
                        "".join(op for _, op in sorted(kept))))
        else:
            ops = "".join(op for _, op in sorted(leaves[i]))
            out.append((QuickedStatus.QUICKED_OK, ops))
    return out
