"""Device-side banded traceback: a column scan over the full-fill planes.

Consumes the (T, EBB, B) uint32 Pv/Mv band snapshots that the full
banded kernels write to device memory and walks the alignment path ON
DEVICE,
reproducing banded_backtrace_matrix_cutoff (bpm_banded.c:967-1036)
cell-exactly: tie-break D, I, M, X with a RAW-character M-test.

Shape of the walk: at a fixed text column h, the greedy order repeats D
(v-1, h unchanged) while the band-frame Pv bit below the cursor is set,
then takes exactly ONE column-consuming step (I, M or X). So the whole
traceback is a `lax.scan` over columns h = T-1 .. 0 where each active
lane (a) consumes its entire D-run in one iteration — run length =
cursor - highest ZERO Pv bit at or below it, by unrolled u32 bit
arithmetic — and (b) makes the single I/M/X decision from the previous
column's Mv word and a raw-match bitplane packed once per batch. No
per-lane gathers anywhere: the walk is a scan of lane-parallel bit
arithmetic.

The scan emits one (d_run, opcode) RECORD per column per lane instead
of op characters, so the device->host readback is ~5 bytes/column
rather than the 16*EBB bytes/column of raw band planes. Hosts expand
records to op strings with one vectorized np.repeat.

Validated against traceback_np.banded_traceback_pair (the byte-parity
spec) on 480 randomized plane sets before the port; parity tests in
tests/test_banded_traceback_jax.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

W = 64
U32 = jnp.uint32
I32 = jnp.int32

# opcode values match windowed_jax._OP_CHARS: 1=M, 2=D, 3=I, 4=X
_OP_BYTES = np.array([0, ord("M"), ord("D"), ord("I"), ord("X")],
                     dtype=np.uint8)


def _hsb32(y):
    """Highest set bit of uint32 lanes (garbage 0 for y == 0 — callers
    mask). Exact 5-step binary search (the f32-exponent trick mis-rounds
    0xFFFFFFFF up to 2^32)."""
    p = jnp.zeros(y.shape, I32)
    for k in (16, 8, 4, 2, 1):
        t = y >> jnp.uint32(k)
        big = t != 0
        p = p + jnp.where(big, k, 0)
        y = jnp.where(big, t, y)
    return p


def _mask_le(nbit, w):
    """uint32 mask of bits <= nbit within word w (32-bit windows)."""
    d = nbit - 32 * w
    dc = jnp.clip(d, 0, 30).astype(U32)
    return jnp.where(d >= 31, jnp.uint32(0xFFFFFFFF),
                     jnp.where(d < 0, jnp.uint32(0),
                               (jnp.uint32(2) << dc) - jnp.uint32(1)))


def _bit_at(words, NWDS, pos):
    """Bit `pos` (per-lane i32) from an (NWDS, B) u32 word stack via an
    unrolled select chain (no gathers); out-of-range pos reads 0."""
    wsel = pos >> 5
    bsel = (pos & 31).astype(U32)
    out = jnp.zeros(pos.shape, U32)
    for w in range(NWDS):
        out = jnp.where(wsel == w, (words[w] >> bsel) & jnp.uint32(1), out)
    return out


def traceback_records_impl(pv_lo, pv_hi, mv_lo, mv_hi, praw, traw,
                           plen, tlen, prolog, *, EBB: int, PP: int):
    """Column-scan traceback. planes (T, EBB, B) u32; praw (PP, B) i32
    (pad fill must never equal a text byte); traw (T, B) i32; plen,
    tlen, prolog (B,) i32. Returns (runs (T,B) i32, opc (T,B) i8,
    v_fin (B,), h_fin (B,)) — records expand host-side via
    expand_records. Unjitted; see traceback_records."""
    T, _, B = pv_lo.shape
    NW = 2 * EBB          # u32 words per band column
    NBITS = EBB * W
    NWP = PP // 32        # u32 words per absolute-frame match column

    # Raw-char match bitplane: bit v of word w at column h answers
    # "praw[32w + bit] == traw[h]" (absolute pattern frame); packed once.
    mm = praw[:, None, :] == traw[None, :, :]
    w32 = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    match_cols = (mm.astype(U32).reshape(NWP, 32, T, B)
                  * w32[None, :, None, None]).sum(axis=1, dtype=U32)
    match_cols = match_cols.transpose(1, 0, 2)          # (T, NWP, B)

    # xs word stacks: Pv at column h+1 is plane index h; Mv at column h
    # is plane index h-1 (h == 0 reads the all-zero init column).
    def words(lo, hi):
        # (T, EBB, B) lo/hi -> (T, NW, B), word 2i = block i lo
        return jnp.stack([lo, hi], axis=2).reshape(T, NW, B)

    pv_cols = words(pv_lo, pv_hi)
    mv_cols = words(mv_lo, mv_hi)
    zero_col = jnp.zeros((1, NW, B), U32)
    mv_cols = jnp.concatenate([zero_col, mv_cols[:-1]], axis=0)

    hs = jnp.arange(T, dtype=I32)

    def step(carry, xs):
        v, h_track = carry
        hc, pvw, mvw, mw = xs
        act = (h_track == hc) & (v >= 0)
        # --- D-run: band frame of column h+1 ---
        bp_r = v - W * ((hc + 1) // W) + W * prolog
        bpc = jnp.clip(bp_r, 0, NBITS - 1)
        hz = jnp.full((B,), -1, I32)
        for w in range(NW):
            y = (~pvw[w]) & _mask_le(bpc, w)
            hz = jnp.where(y != 0, 32 * w + _hsb32(y), hz)
        run_raw = bpc - hz
        run = jnp.minimum(run_raw, v + 1)               # v >= 0 loop bound
        run = jnp.where((bp_r < 0) | (bp_r >= NBITS), 0, run)
        run = jnp.where(act, run, 0)
        v1 = v - run
        ended_v = v1 < 0
        # --- trailing column-consuming step at (v1, h) ---
        v1u = jnp.maximum(v1, 0)
        eff_v = v1u - W * (hc // W) + W * prolog        # band frame of col h
        in_band = (eff_v >= 0) & (eff_v < NBITS)
        ibit = jnp.where(in_band,
                         _bit_at(mvw, NW, jnp.clip(eff_v, 0, NBITS - 1)), 0)
        mbit = _bit_at(mw, NWP, v1u)                    # absolute frame
        is_i = ibit == 1
        opc = jnp.where(is_i, 3, jnp.where(mbit == 1, 1, 4)).astype(jnp.int8)
        opc = jnp.where(act & ~ended_v, opc, jnp.int8(0))
        dec_v = jnp.where(is_i, 0, 1)
        v = jnp.where(act, jnp.where(ended_v, v1, v1 - dec_v), v)
        h_track = jnp.where(act & ~ended_v, h_track - 1, h_track)
        return (v, h_track), (run, opc)

    (v_fin, h_fin), (runs, opcs) = jax.lax.scan(
        step, (plen - 1, tlen - 1),
        (hs, pv_cols, mv_cols, match_cols), reverse=True)
    return runs, opcs, v_fin, h_fin


traceback_records = partial(jax.jit, static_argnames=("EBB", "PP"))(
    traceback_records_impl)


@partial(jax.jit, static_argnames=("EBB", "PP"))
def _records_lane_major(pv_lo, pv_hi, mv_lo, mv_hi, praw, traw, plen, tlen,
                        prolog, *, EBB: int, PP: int):
    """Records for the host expansion: runs u16 (NBITS = EBB*64 < 65536
    always) and opcodes, transposed ON DEVICE to (B, T) — the host
    walks records per lane, so a lane-major readback saves a strided
    host pass."""
    runs, opcs, v_f, h_f = traceback_records_impl(
        pv_lo, pv_hi, mv_lo, mv_hi, praw, traw, plen, tlen, prolog,
        EBB=EBB, PP=PP)
    return (runs.astype(jnp.uint16).T, opcs.T, v_f, h_f)


def traceback_ops_device(mats, praw_np, traw_np, plen, tlen, prolog, *,
                         EBB: int, n: int) -> list[str]:
    """Device traceback over a full fill's (T, EBB, B) planes (4 device
    arrays, consumed in place); returns op strings for the first n
    lanes. The only device->host transfer is ~3 bytes/column of records
    (vs 16*EBB bytes/column of raw planes)."""
    PP = praw_np.shape[0]
    out = _records_lane_major(
        mats[0], mats[1], mats[2], mats[3],
        jnp.asarray(praw_np), jnp.asarray(traw_np),
        jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(prolog),
        EBB=EBB, PP=PP)
    runs_bt, opcs_bt, v_f, h_f = jax.device_get(list(out))
    from quicked_tpu import native
    packed = native.expand_colruns(runs_bt[:n], opcs_bt[:n], v_f[:n],
                                   h_f[:n]) if native.available() else None
    if packed is None:
        packed = records_to_packed(runs_bt.astype(np.int32), opcs_bt,
                                   v_f, h_f, n=n)
    flat, starts, lens = packed
    buf = flat.tobytes()
    return [buf[s:s + l].decode("ascii")
            for s, l in zip(starts.tolist(), lens.tolist())]


def prep_raw_frames(patterns_raw, texts_raw, T: int, PP: int,
                    pad_to_b: int | None = None):
    """(PP, B) / (T, B) uint8 raw-char frames (¼ the upload of i32).
    Pad positions hold 0 — safe because the M-test is only ever
    consulted at (v1 <= plen-1, h <= tlen-1): active lanes never read a
    pad row, and pad lanes (plen == 0) never activate."""
    B = pad_to_b or len(patterns_raw)
    return _frame(patterns_raw, PP, B), _frame(texts_raw, T, B)


def _frame(seqs, rows: int, B: int) -> np.ndarray:
    """Byte strings (or uint8 arrays) as the columns of a zero-padded
    (rows, B) frame: one concatenation and one scatter for the batch."""
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    flat = np.frombuffer(b"".join(seqs), np.uint8)
    starts = np.cumsum(lens) - lens
    lane = np.repeat(np.arange(len(seqs)), lens)
    pos = np.arange(flat.size) - np.repeat(starts, lens)
    out = np.zeros((B, rows), np.uint8)
    out[lane, pos] = flat
    return np.ascontiguousarray(out.T)


def records_to_packed(runs_bt, opcs_bt, v_fin, h_fin,
                      n: int | None = None):
    """(B, T) lane-major column records -> one packed op-byte buffer +
    per-lane (start, length): 'D'*(v+1) + 'I'*(h+1) + ascending-h
    (op + 'D'*run) — the reference's right-to-left buffer, reversed.
    One vectorized np.repeat, no per-lane Python work (the packed form
    feeds the same lazy/batched CIGAR machinery as the native lane)."""
    runs_bt = np.asarray(runs_bt)
    opcs_bt = np.asarray(opcs_bt)
    v_fin = np.asarray(v_fin)
    h_fin = np.asarray(h_fin)
    B, T = runs_bt.shape
    n = B if n is None else n
    runs_bt = runs_bt[:n]
    opcs_bt = opcs_bt[:n]
    # per lane: values [D, I, op_0, D, op_1, D, ...], counts to match
    vals = np.empty((n, 2 + 2 * T), dtype=np.uint8)
    cnts = np.empty((n, 2 + 2 * T), dtype=np.int32)
    vals[:, 0] = ord("D")
    cnts[:, 0] = np.maximum(v_fin[:n] + 1, 0)
    vals[:, 1] = ord("I")
    cnts[:, 1] = np.maximum(h_fin[:n] + 1, 0)
    # ascending h: op then its column's D-run
    vals[:, 2::2] = _OP_BYTES[opcs_bt]
    cnts[:, 2::2] = opcs_bt != 0
    vals[:, 3::2] = ord("D")
    cnts[:, 3::2] = runs_bt
    flat = np.repeat(vals.ravel(), cnts.ravel())
    tot = cnts.sum(axis=1, dtype=np.int64)
    ends = np.cumsum(tot)
    return flat, ends - tot, tot


def expand_records(runs, opcs, v_fin, h_fin, n: int | None = None):
    """(T, B) records -> per-lane op strings (tests / small batches;
    the hot path keeps the packed form from records_to_packed)."""
    flat, starts, lens = records_to_packed(
        np.asarray(runs).T, np.asarray(opcs).T, v_fin, h_fin, n)
    buf = flat.tobytes()
    return [buf[s:s + l].decode("ascii")
            for s, l in zip(starts.tolist(), lens.tolist())]
