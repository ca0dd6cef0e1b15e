"""Batched WindowEd kernel as a pure-JAX while-loop of window steps.

Bit-exact batch re-expression of the reference windowed heuristic
(bpm_windowed.c:202-628, score-only mode): every pair occupies one lane;
each iteration fills one (64*ws x 64*ws)-cell window with the Myers
advance (no level masks, bpm_windowed.c:254-279) and greedily backtraces
inside it (windowed_backtrace_score_only, bpm_windowed.c:504-561),
counting High-Error Windows. Lanes run in lockstep along their own
diagonals; finished lanes are masked.

The shifted PEQ window build (bpm_windowed.c:237-244) becomes a per-lane
64-bit funnel shift on (lo, hi) uint32 pairs (ops/u64.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from quicked_tpu import dna
from quicked_tpu.ops import u64
from quicked_tpu.ops.myers_np import div_ceil

W = 64
U32 = jnp.uint32
I32 = jnp.int32
TOPBIT_HI = 0x80000000  # plain int: avoid a device-array module constant


@dataclasses.dataclass
class WindowedBatch:
    """Fixed-shape arrays for one windowed kernel invocation."""

    B: int
    KP: int                 # pattern PEQ rows
    T: int                  # text columns (>= 64*ws)
    P: int                  # pattern rows
    peq_lo: np.ndarray      # (KP, 5, B) u32
    peq_hi: np.ndarray
    text_enc: np.ndarray    # (T, B) i32
    text_raw: np.ndarray    # (T, B) i32 — raw bytes; M-test compares RAW
    pat_raw: np.ndarray     # (P, B) i32
    plen: np.ndarray        # (B,) i32
    tlen: np.ndarray
    num_words: np.ndarray


def hew_cell_threshold(window_size: int, overlap_size: int,
                       hew_threshold: int) -> int:
    """Cell-count threshold above which a window counts as high-error
    (bpm_windowed.c:925 semantics) — the ONE definition shared by the
    device kernel, the sharded driver, and callers."""
    return (window_size - overlap_size) * W * hew_threshold // 100


def _raw_i32(s, enc) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return np.asarray(enc, dtype=np.int32)
    if s.isascii():
        return np.frombuffer(s.encode("ascii"),
                             dtype=np.uint8).astype(np.int32)
    # true char compare for non-ASCII input: an errors='replace' encode
    # would collapse distinct chars to '?' and let the M-test match them
    # (the cigar.check_alignment convention)
    return np.fromiter(map(ord, s), dtype=np.int32, count=len(s))


def prepare_windowed_batch(patterns, texts, *, window_size: int,
                           pad_to_b: int | None = None,
                           min_kp: int | None = None,
                           min_t: int | None = None,
                           min_p: int | None = None) -> WindowedBatch:
    n = len(patterns)
    enc_p = [p if isinstance(p, np.ndarray) else dna.encode(p)
             for p in patterns]
    enc_t = [t if isinstance(t, np.ndarray) else dna.encode(t) for t in texts]
    plen = np.array([len(p) for p in enc_p], dtype=np.int32)
    tlen = np.array([len(t) for t in enc_t], dtype=np.int32)
    B = pad_to_b or n
    assert B >= n
    cols = W * window_size
    KP = max(max(div_ceil(int(L), W), 1) for L in plen) if n else 1
    if min_kp:
        KP = max(KP, min_kp)
    T = max(int(tlen.max()) if n else 1, cols)
    if min_t:
        T = max(T, min_t)
    # at least one window tall: the kernel slices (cols,)-windows
    P = max(int(plen.max()) if n else 1, cols)
    if min_p:
        P = max(P, min_p)

    from quicked_tpu.ops.batch_prep import pack_peq_batch

    peq_lo = np.zeros((KP, 5, B), dtype=np.uint32)
    peq_hi = np.zeros((KP, 5, B), dtype=np.uint32)
    text_enc = np.zeros((T, B), dtype=np.int32)
    text_raw = np.full((T, B), -1, dtype=np.int32)
    pat_raw = np.full((P, B), -2, dtype=np.int32)
    num_words = np.ones(B, dtype=np.int32)

    if n:
        max_nw = max(max(div_ceil(int(L), W), 1) for L in plen)
        lo, hi = pack_peq_batch(enc_p, max_nw)   # (max_nw, 5, n)
        peq_lo[:max_nw, :, :n] = lo
        peq_hi[:max_nw, :, :n] = hi
        num_words[:n] = np.maximum((plen.astype(np.int64) + W - 1) // W, 1)
    for b in range(n):
        tl = int(tlen[b])
        text_enc[:tl, b] = enc_t[b].astype(np.int32)
        text_raw[:tl, b] = _raw_i32(texts[b], enc_t[b])
        pl = int(plen[b])
        pat_raw[:pl, b] = _raw_i32(patterns[b], enc_p[b])

    def vec(x, fill=0):
        out = np.full(B, fill, dtype=np.int32)
        out[:n] = x
        return out

    return WindowedBatch(B=B, KP=KP, T=T, P=P, peq_lo=peq_lo, peq_hi=peq_hi,
                         text_enc=text_enc, text_raw=text_raw,
                         pat_raw=pat_raw, plen=vec(plen, fill=0),
                         tlen=vec(tlen, fill=0), num_words=num_words)


def _gather_rows(arr, rows, WS, B):
    """arr (KP, 5, B), rows (WS, B) -> (WS, 5, B) gather along axis 0."""
    idx = jnp.broadcast_to(rows[:, None, :], (WS, 5, B))
    return jnp.take_along_axis(arr, idx, axis=0)


def _gather_lane(arr, idx):
    """arr (N, B), idx (B,) -> (B,) per-lane gather."""
    return jnp.take_along_axis(arr, idx[None, :], axis=0)[0]


def _lane_windows(arr, starts, COLS, B):
    """Per-lane contiguous windows: arr (T, B), starts (B,) ->
    (COLS, B) with out[i, b] = arr[starts[b] + i, b].

    Starts are provably bounded: start = max(pos - COLS + 1, 0) and
    pos <= T - 1, so 0 <= start <= T - COLS. That makes the common
    device regimes STATIC shortcuts: T == COLS means every start is 0
    (the window IS the array — short reads fit one window), and small
    T - COLS means a handful of masked shifted copies. The general
    take_along_axis gather lowers to an O(rows x lanes) one-hot sweep,
    the kernel's hot cost where it runs; it remains only for wide-T
    batches (long reads, which route to the host C walk anyway) and
    tiny lane counts.
    """
    T = arr.shape[0]
    if T == COLS:
        return arr
    if B <= 32:
        cols = []
        for b in range(B):
            cols.append(jax.lax.dynamic_slice(arr[:, b],
                                              (starts[b],), (COLS,)))
        return jnp.stack(cols, axis=1)
    if T - COLS <= 48:
        out = arr[:COLS]
        for s in range(1, T - COLS + 1):
            out = jnp.where(starts[None, :] == s, arr[s:s + COLS], out)
        return out
    idx = starts[None, :] + jnp.arange(COLS, dtype=I32)[:, None]
    return jnp.take_along_axis(arr, idx, axis=0)


def _hsb32(y):
    """Highest set bit index of uint32 lanes (garbage 0 for y == 0 —
    callers mask). Exact 5-step binary search: the f32-exponent trick
    mis-rounds 0xFFFFFFFF up to 2^32."""
    p = jnp.zeros(y.shape, I32)
    for k in (16, 8, 4, 2, 1):
        t = y >> jnp.uint32(k)
        big = t != 0
        p = p + jnp.where(big, k, 0)
        y = jnp.where(big, t, y)
    return p


def windowed_scan_impl(peq_lo, peq_hi, text_enc, text_raw, pat_raw, plen,
                       tlen, num_words, hew_cells, *, WS: int, OVL: int,
                       full: bool = False):
    """Windowed driver loop (windowed_compute, bpm_windowed.c:563-628).

    Score-only mode (full=False) returns (score, hew). Full-CIGAR mode
    (full=True) emits one (d_run, opcode) RECORD per window column into
    (MW, COLS, B) buffers (window index = loop count: lanes run their
    windows in lockstep) and returns (recs_run, recs_op, pos_v, pos_h);
    hosts expand records to op strings (run_windowed_full). Unjitted —
    shared by the single-chip jit wrapper and the shard_map path
    (parallel/mesh.py).

    Both backtraces are COLUMN SCANS, not step walks: scanning window
    columns descending, each active lane consumes its whole run of D
    steps in one iteration (highest-zero-bit arithmetic on the
    column's D-predicate words — greedy D repeats while the bit below
    the cursor is set; in full mode M outranks D so the predicate is
    Pv & ~match) followed by the single column-consuming decision, with
    raw-char M-tests read from a bitplane packed once per window. Zero
    per-lane gathers: a step walk's take_along_axis lowers to an
    O(rows x lanes) one-hot sweep per step. Validated cell-exact vs windowed_backtrace[_score_only]
    semantics (bpm_windowed.c:448-561) on 1068 randomized model cases
    before the port."""
    B = plen.shape[0]
    KP = peq_lo.shape[0]
    COLS = W * WS
    # window-count bound: every window advances pos_v + pos_h by at
    # least W*(WS-OVL) (the overlap exit), except the final one
    MW = -(-(pat_raw.shape[0] + text_enc.shape[0])
           // (W * max(WS - OVL, 1))) + 2
    zeros_u = jnp.zeros((B,), U32)
    mask_lo = jnp.zeros((B,), U32)
    mask_hi = jnp.full((B,), TOPBIT_HI, U32)

    def cond(state):
        pos_v, pos_h = state[0], state[1]
        return jnp.any((pos_v >= 0) & (pos_h >= 0))

    def body(state):
        if full:
            pos_v, pos_h = state[0], state[1]
        else:
            pos_v, pos_h, score, hew = state
        active = (pos_v >= 0) & (pos_h >= 0)
        pv_pos = jnp.maximum(pos_v, 0)
        ph_pos = jnp.maximum(pos_h, 0)
        v_min = jnp.maximum(pv_pos - COLS + 1, 0)
        h_min = jnp.maximum(ph_pos - COLS + 1, 0)
        shift = v_min % W
        v_block = v_min // W

        # ---- shifted PEQ window build (bpm_windowed.c:237-244) ----
        rows = v_block[None, :] + jnp.arange(WS, dtype=I32)[:, None]  # (WS,B)
        rows_c = jnp.minimum(rows, KP - 1)
        rows_c1 = jnp.minimum(rows + 1, KP - 1)
        lo_lo = _gather_rows(peq_lo, rows_c, WS, B)
        lo_hi = _gather_rows(peq_hi, rows_c, WS, B)
        hi_lo = _gather_rows(peq_lo, rows_c1, WS, B)
        hi_hi = _gather_rows(peq_hi, rows_c1, WS, B)
        in_pat = (rows < num_words[None, :])[:, None, :]
        in_pat1 = ((rows + 1) < num_words[None, :])[:, None, :]
        ones = jnp.uint32(0xFFFFFFFF)
        lo_lo = jnp.where(in_pat, lo_lo, ones)
        lo_hi = jnp.where(in_pat, lo_hi, ones)
        hi_lo = jnp.where(in_pat1, hi_lo, 0)
        hi_hi = jnp.where(in_pat1, hi_hi, 0)
        s = jnp.broadcast_to(shift[None, None, :], (WS, 5, B))
        peq_win_lo, peq_win_hi = u64.funnel_shift_right(
            lo_lo, lo_hi, hi_lo, hi_hi, s)

        # ---- per-lane local windows of the sequences ----
        text_win_enc = _lane_windows(text_enc, h_min, COLS, B)
        text_win_raw = _lane_windows(text_raw, h_min, COLS, B)
        pat_win_raw = _lane_windows(pat_raw, v_min, COLS, B)

        # ---- window fill (windowed_compute_window, bpm_windowed.c:202-280)
        pv_init = jnp.where((h_min == 0)[None, :],
                            jnp.full((WS, B), 0xFFFFFFFF, U32),
                            jnp.zeros((WS, B), U32))
        ph_first = jnp.where(v_min == 0, jnp.ones((B,), U32), zeros_u)
        NW = 2 * WS

        def fill(carry, tp):
            pv_lo, pv_hi, mv_lo, mv_hi = carry
            c = text_win_enc[tp]
            phin, mhin = ph_first, zeros_u
            npv_lo, npv_hi, nmv_lo, nmv_hi = [], [], [], []
            for i in range(WS):
                eq_lo, eq_hi = u64.select_eq(
                    c, peq_win_lo[i], peq_win_hi[i])
                a, b, cc, d, phout, mhout = u64.advance_block64(
                    eq_lo, eq_hi, mask_lo, mask_hi,
                    pv_lo[i], pv_hi[i], mv_lo[i], mv_hi[i], phin, mhin)
                npv_lo.append(a)
                npv_hi.append(b)
                nmv_lo.append(cc)
                nmv_hi.append(d)
                phin, mhin = phout, mhout
            out = (jnp.stack(npv_lo), jnp.stack(npv_hi),
                   jnp.stack(nmv_lo), jnp.stack(nmv_hi))
            # Column-scan word layout (word 2i = block i lo, 2i+1 = hi):
            # emit (Pv AFTER this column, Mv BEFORE it) = exactly the
            # (PvW[c], MvW[c-1]) pair column c = tp + 1 backtraces with.
            pv_w = jnp.stack([x for pr in zip(npv_lo, npv_hi) for x in pr])
            mv_w = jnp.stack([x for pr in zip(mv_lo, mv_hi) for x in pr])
            return out, (pv_w, mv_w)

        carry0 = (pv_init, pv_init, jnp.zeros((WS, B), U32),
                  jnp.zeros((WS, B), U32))
        _, snaps = jax.lax.scan(fill, carry0, jnp.arange(COLS, dtype=I32))

        # ---- greedy in-window backtrace as a COLUMN SCAN (zero
        # per-lane gathers); score-only tie-break D,I,M,X
        # (windowed_backtrace_score_only, bpm_windowed.c:504-561); full
        # tie-break M,D,I,X (windowed_backtrace, bpm_windowed.c:448-502)
        v_ovl = jnp.maximum(pv_pos - W * (WS - OVL) + 1, 0)
        h_ovl = jnp.maximum(ph_pos - W * (WS - OVL) + 1, 0)

        pv_cols, mv_cols = snaps                     # (COLS, NW, B) u32
        # Raw-char match bitplane: bit (32w + j) of word w at column tp
        # answers "pat_win_raw[32w + j] == text_win_raw[tp]" — packed
        # once per window; the per-step one-hot char gather was the
        # other half of the round-3 backtrace cost.
        mm = pat_win_raw[:, None, :] == text_win_raw[None, :, :]
        w32 = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
        match_cols = (mm.astype(U32).reshape(NW, 32, COLS, B)
                      * w32[None, :, None, None]).sum(axis=1, dtype=U32)
        match_cols = match_cols.transpose(1, 0, 2)   # (COLS, NW, B)

        v_ovl_rel = v_ovl - v_min
        h_ovl_rel = h_ovl - h_min

        def _bit_sel(words, pos):
            """Bit `pos` of an (NW, B) word stack via unrolled selects."""
            wsel = pos >> 5
            bsel = (pos & 31).astype(U32)
            out = jnp.zeros((B,), U32)
            for w in range(NW):
                out = jnp.where(wsel == w,
                                (words[w] >> bsel) & jnp.uint32(1), out)
            return out

        def _mask_le(nbit, w):
            """uint32 mask of bits <= nbit within 32-bit window w."""
            d = nbit - 32 * w
            dc = jnp.clip(d, 0, 30).astype(U32)
            return jnp.where(d >= 31, jnp.uint32(0xFFFFFFFF),
                             jnp.where(d < 0, jnp.uint32(0),
                                       (jnp.uint32(2) << dc)
                                       - jnp.uint32(1)))

        def btstep(carry, xs):
            """One column: the lane's whole D-run (highest-ZERO-bit
            arithmetic on the D-predicate word, clamped by the
            v>=v_overlap step bound) plus the single column-consuming
            decision. Full mode: D fires only where Pv & ~match (M
            outranks D); emits (run, opcode) records. Score mode:
            D-predicate is Pv alone; accumulates the cell count."""
            if full:
                vr, h_rel = carry
            else:
                vr, h_rel, sc = carry
            c, pvw, mvw, mw = xs
            act = (active & (h_rel == c - 1) & (vr >= v_ovl_rel)
                   & (h_rel >= h_ovl_rel))
            vru = jnp.clip(vr, 0, COLS - 1)
            hz = jnp.full((B,), -1, I32)
            for w in range(NW):
                xw = (pvw[w] & ~mw[w]) if full else pvw[w]
                y = (~xw) & _mask_le(vru, w)
                hz = jnp.where(y != 0, 32 * w + _hsb32(y), hz)
            run_raw = vru - hz
            max_run = vru - v_ovl_rel + 1
            run = jnp.minimum(run_raw, max_run)
            ended = run == max_run          # window exit mid-run
            v1 = vru - run
            # trailing step at (v1, h): match/Mv bits decide M/I/X
            v1u = jnp.clip(v1, 0, COLS - 1)
            ib = _bit_sel(mvw, v1u)         # PREVIOUS column's Mv
            mb = _bit_sel(mw, v1u)          # raw match at (v1, h)
            if full:
                is_m = mb == 1
                is_i = (~is_m) & (ib == 1)
                opc = jnp.where(is_m, 1,
                                jnp.where(is_i, 3, 4)).astype(jnp.int8)
                opc = jnp.where(act & ~ended, opc, jnp.int8(0))
                run_out = jnp.where(act, run, 0).astype(jnp.int16)
            else:
                is_i = ib == 1
                step_sc = jnp.where(is_i, 1, jnp.where(mb == 1, 0, 1))
                sc = sc + jnp.where(act,
                                    run + jnp.where(ended, 0, step_sc), 0)
            vr = jnp.where(act, jnp.where(ended, v1,
                                          v1 - jnp.where(is_i, 0, 1)), vr)
            h_rel = jnp.where(act & ~ended, h_rel - 1, h_rel)
            if full:
                return (vr, h_rel), (run_out, opc)
            return (vr, h_rel, sc), None

        cs = jnp.arange(1, COLS + 1, dtype=I32)
        if full:
            pos_v, pos_h, recs_run, recs_op, widx = state
            (vr_f, hr_f), (rr, oo) = jax.lax.scan(
                btstep, (pv_pos - v_min, ph_pos - h_min),
                (cs, pv_cols, mv_cols, match_cols), reverse=True)
            # one record block per window iteration (lanes run windows
            # in lockstep, so the window index is the shared loop count)
            wc = jnp.minimum(widx, MW - 1)
            recs_run = jax.lax.dynamic_update_slice(recs_run, rr[None],
                                                    (wc, 0, 0))
            recs_op = jax.lax.dynamic_update_slice(recs_op, oo[None],
                                                   (wc, 0, 0))
            pos_v = jnp.where(active, v_min + vr_f, pos_v)
            pos_h = jnp.where(active, h_min + hr_f, pos_h)
            return (pos_v, pos_h, recs_run, recs_op, widx + 1)
        (vr_f, hr_f, sc_f), _ = jax.lax.scan(
            btstep, (pv_pos - v_min, ph_pos - h_min, jnp.zeros((B,), I32)),
            (cs, pv_cols, mv_cols, match_cols), reverse=True)
        hew = hew + (active & (sc_f > hew_cells)).astype(I32)
        score = score + jnp.where(active, sc_f, 0)
        pos_v = jnp.where(active, v_min + vr_f, pos_v)
        pos_h = jnp.where(active, h_min + hr_f, pos_h)
        return (pos_v, pos_h, score, hew)

    if full:
        state0 = (plen - 1, tlen - 1,
                  jnp.zeros((MW, COLS, B), jnp.int16),
                  jnp.zeros((MW, COLS, B), jnp.int8), jnp.int32(0))
        pos_v, pos_h, recs_run, recs_op, _ = jax.lax.while_loop(
            cond, body, state0)
        return recs_run, recs_op, pos_v, pos_h
    state0 = (plen - 1, tlen - 1, jnp.zeros((B,), I32), jnp.zeros((B,), I32))
    pos_v, pos_h, score, hew = jax.lax.while_loop(cond, body, state0)
    # Boundary fill (bpm_windowed.c:599-627, score-only accounting).
    score = score + jnp.where(pos_h >= 0, pos_h + 1, 0)
    score = score + jnp.where(pos_v >= 0, pos_v + 1, 0)
    return score, hew


_windowed_scan = partial(jax.jit,
                         static_argnames=("WS", "OVL", "full"))(
    windowed_scan_impl)

_OP_CHARS = {1: "M", 2: "D", 3: "I", 4: "X"}
_OP_BYTES = np.array([0, ord("M"), ord("D"), ord("I"), ord("X")],
                     dtype=np.uint8)


def expand_window_records(runs, opcs, pos_v, pos_h,
                          n: int | None = None) -> list[str]:
    """Expand (MW, COLS, B) per-window column records to forward-order
    op strings: 'D'*(pos_v+1) + 'I'*(pos_h+1) + for windows DESCENDING
    (the last window processed is the leftmost piece), columns
    ascending: op + 'D'*d_run — the reference's right-to-left buffer,
    reversed. One vectorized np.repeat per lane chunk."""
    runs = np.asarray(runs)
    opcs = np.asarray(opcs)
    pos_v = np.asarray(pos_v)
    pos_h = np.asarray(pos_h)
    MW, COLS, B = runs.shape
    n = B if n is None else n
    R = MW * COLS
    rflat = runs[::-1].reshape(R, B)
    oflat = opcs[::-1].reshape(R, B)
    out = []
    CH = max(1, (1 << 24) // max(R, 1))        # bound temp arrays
    for s in range(0, n, CH):
        e = min(s + CH, n)
        m = e - s
        vals = np.empty((m, 2 + 2 * R), dtype=np.uint8)
        cnts = np.empty((m, 2 + 2 * R), dtype=np.int64)
        vals[:, 0] = ord("D")
        cnts[:, 0] = np.maximum(pos_v[s:e] + 1, 0)
        vals[:, 1] = ord("I")
        cnts[:, 1] = np.maximum(pos_h[s:e] + 1, 0)
        vals[:, 2::2] = _OP_BYTES[oflat[:, s:e]].T
        cnts[:, 2::2] = (oflat[:, s:e] != 0).T
        vals[:, 3::2] = ord("D")
        cnts[:, 3::2] = rflat[:, s:e].T
        flat = np.repeat(vals.ravel(), cnts.ravel())
        tot = cnts.sum(axis=1)
        ends = np.cumsum(tot)
        starts = ends - tot
        buf = flat.tobytes()
        out.extend(buf[starts[i]:ends[i]].decode("ascii")
                   for i in range(m))
    return out


def run_windowed_full(batch: WindowedBatch, window_size: int,
                      overlap_size: int) -> list[str]:
    """Full-CIGAR windowed mode: returns forward-order op strings per
    pair (windowed_compute CIGAR path, bpm_windowed.c:563-628). The
    kernel emits compact per-column (d_run, op) records; the boundary
    runs (bpm_windowed.c:599-627) land at the front after the
    reference's final reversal."""
    dummy = np.zeros(batch.B, dtype=np.int32)
    recs_run, recs_op, pos_v, pos_h = _windowed_scan(
        jnp.asarray(batch.peq_lo), jnp.asarray(batch.peq_hi),
        jnp.asarray(batch.text_enc), jnp.asarray(batch.text_raw),
        jnp.asarray(batch.pat_raw), jnp.asarray(batch.plen),
        jnp.asarray(batch.tlen), jnp.asarray(batch.num_words),
        jnp.asarray(dummy), WS=window_size, OVL=overlap_size, full=True)
    # one batched transfer (separate np.asarray calls pay a device
    # round trip each — latency-bound on high-latency links)
    recs_run, recs_op, pos_v, pos_h = jax.device_get(
        [recs_run, recs_op, pos_v, pos_h])
    return expand_window_records(recs_run, recs_op, pos_v, pos_h,
                                 n=batch.B)


def run_windowed_score(batch: WindowedBatch, hew_threshold: int,
                       window_size: int, overlap_size: int, device=None):
    """Execute the score-only windowed kernel; returns (score, hew) numpy.

    `device` optionally pins execution to one device (chip_smoke.py
    times the GPU against the CPU backend with it)."""
    import contextlib

    hew_cells = np.full(batch.B,
                        hew_cell_threshold(window_size, overlap_size,
                                           hew_threshold),
                        dtype=np.int32)
    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    with ctx:
        score, hew = _windowed_scan(
            jnp.asarray(batch.peq_lo), jnp.asarray(batch.peq_hi),
            jnp.asarray(batch.text_enc), jnp.asarray(batch.text_raw),
            jnp.asarray(batch.pat_raw), jnp.asarray(batch.plen),
            jnp.asarray(batch.tlen), jnp.asarray(batch.num_words),
            jnp.asarray(hew_cells), WS=window_size, OVL=overlap_size)
    return tuple(jax.device_get([score, hew]))
