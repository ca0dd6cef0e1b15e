"""Batched banded Myers kernel for the GPU: Pallas on the Triton route.

Score-only and full (traceback) variants, pairs as lanes: one program
owns a tile of `lanes` pairs (one thread each) and runs the whole text
sweep of its tile, NB blocks of 64 columns, inside the program. Same
dataflow and arithmetic as the plain reference (banded_jax.
banded_scan_impl), bit-exact outputs; what the kernel changes is the
order and the place of the work:

  - one launch per batch instead of the XLA scan's NB * 64 * EBB
    sequential loop steps;
  - inside a 64-column block the loop runs over band rows outside and
    columns inside. A row's Pv/Mv words, its scores-window entry, PEQ
    and level-mask words are loaded once per block and stay in
    registers across the 64 columns; the vertical carries between rows
    travel as one 64-bit mask per lane (bit j = column j). Rows
    outside the tile's live band [min(first), max(last)] are skipped,
    as the reference skips them (bpm_banded.c:830-886);
  - the band state lives in the kernel's own outputs (device memory,
    small enough to stay in L2) and the scores window is kept in the
    absolute shifted-row frame, so the per-block window roll of the
    reference is a single new row;
  - the full variant writes each column's band snapshot straight to
    (T, EBB, B) planes, the layout banded_traceback_jax walks on the
    device.

The band cut/shift decisions come from banded_jax._band_cut, shared
with the reference so the two cannot drift. Text is uploaded one byte
per character and packed four characters per 32-bit word on the card,
which the kernel unpacks with a shift and a mask per column.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from quicked_tpu.ops import u64
from quicked_tpu.ops.banded_jax import _band_cut
from quicked_tpu.ops.batch_prep import BandedBatch

W = 64
WORDS = W // 4      # packed text words per 64-column block
U32 = jnp.uint32
I32 = jnp.int32

# Pairs per program, one thread each. On an H100 (80GB HBM3, 700 W) at
# the 32,768 x 5 kbp headline, 32-pair (one-warp) programs ran the
# batch in 7.3 ms, 64 and 128 in 9.4-9.5 ms; 32 columns unrolled per
# loop step instead of 16 ran 10.4-10.5 ms and compiled in 31 s
# instead of 9 s.
TILE_MAX = 32
TILE_MIN = 16
UNROLL = 16         # columns unrolled per inner-loop step (divides 32)

OUT_NAMES = ("scores_by_k", "pv_lo", "pv_hi", "mv_lo", "mv_hi", "first",
             "last")
MAT_NAMES = ("mat_pv_lo", "mat_pv_hi", "mat_mv_lo", "mat_mv_hi")


def _kernel(peq_lo, peq_hi, lm_lo, lm_hi, text, init, cutoff_r, prolog_r,
            nbr_r, finv_r, tfin_r, first0_r, last0_r, *outs,
            EBB: int, NB: int, FULL: bool, LANES: int):
    scores, pv_lo, pv_hi, mv_lo, mv_hi, first_o, last_o = outs[:7]
    mats = outs[7:]
    planes = (pv_lo, pv_hi, mv_lo, mv_hi)
    prolog = prolog_r[...]
    tfinish = tfin_r[...]
    consts = (cutoff_r[...], prolog, nbr_r[...], finv_r[...], tfinish)
    ones = jnp.full((LANES,), 0xFFFFFFFF, U32)
    zeros = jnp.zeros((LANES,), U32)
    resets = (ones, ones, zeros, zeros)      # Pv = all ones, Mv = 0

    def init_row(i, c):
        for ref, v in zip(planes, resets):
            ref[i, :] = v
        return c

    def init_score(k, c):
        scores[k, :] = init[k, :]
        return c

    jax.lax.fori_loop(0, EBB, init_row, ())
    jax.lax.fori_loop(0, EBB + 1, init_score, ())

    def block(nb, carry):
        first, last = carry
        ncols = jnp.clip(tfinish - nb * W, 0, W)    # live columns per lane

        def row(i, carry):
            ph_lo, ph_hi, mh_lo, mh_hi = carry      # carries from row i-1
            k = nb + i
            e_lo = [peq_lo[k, a, :] for a in range(5)]
            e_hi = [peq_hi[k, a, :] for a in range(5)]
            m_lo = lm_lo[k, :]
            m_hi = lm_hi[k, :]
            is_first = i == first
            band = (i >= first) & (i <= last)

            def group(g, st):
                (cpv_lo, cpv_hi, cmv_lo, cmv_hi, csc,
                 oph_lo, oph_hi, omh_lo, omh_hi) = st
                j0 = g * UNROLL
                upper = j0 >= 32
                sh = (j0 & 31).astype(U32)
                gph = jnp.where(upper, ph_hi, ph_lo) >> sh
                gmh = jnp.where(upper, mh_hi, mh_lo) >> sh
                gph_out = zeros
                gmh_out = zeros
                for jj in range(UNROLL):
                    if jj % 4 == 0:
                        word = text[nb * WORDS + (j0 + jj) // 4, :]
                    c = (word >> (8 * (jj % 4))) & 0xFF
                    eq_lo, eq_hi = e_lo[0], e_hi[0]
                    for a in range(1, 5):
                        eq_lo = jnp.where(c == a, e_lo[a], eq_lo)
                        eq_hi = jnp.where(c == a, e_hi[a], eq_hi)
                    phin = jnp.where(is_first, 1, (gph >> jj) & 1)
                    mhin = jnp.where(is_first, 0, (gmh >> jj) & 1)
                    npv_lo, npv_hi, nmv_lo, nmv_hi, phout, mhout = \
                        u64.advance_block64(eq_lo, eq_hi, m_lo, m_hi,
                                            cpv_lo, cpv_hi, cmv_lo, cmv_hi,
                                            phin.astype(U32),
                                            mhin.astype(U32))
                    act = band & (j0 + jj < ncols)
                    cpv_lo = jnp.where(act, npv_lo, cpv_lo)
                    cpv_hi = jnp.where(act, npv_hi, cpv_hi)
                    cmv_lo = jnp.where(act, nmv_lo, cmv_lo)
                    cmv_hi = jnp.where(act, nmv_hi, cmv_hi)
                    csc = jnp.where(act, csc + phout.astype(I32)
                                    - mhout.astype(I32), csc)
                    gph_out = gph_out | (phout << jj)
                    gmh_out = gmh_out | (mhout << jj)
                    if FULL:
                        # column 63 is rewritten after the band shift
                        t = nb * W + j0 + jj
                        for ref, v in zip(mats, (cpv_lo, cpv_hi, cmv_lo,
                                                 cmv_hi)):
                            ref[t, i, :] = v
                oph_lo = oph_lo | jnp.where(upper, 0, gph_out << sh)
                oph_hi = oph_hi | jnp.where(upper, gph_out << sh, 0)
                omh_lo = omh_lo | jnp.where(upper, 0, gmh_out << sh)
                omh_hi = omh_hi | jnp.where(upper, gmh_out << sh, 0)
                return (cpv_lo, cpv_hi, cmv_lo, cmv_hi, csc,
                        oph_lo, oph_hi, omh_lo, omh_hi)

            st = (pv_lo[i, :], pv_hi[i, :], mv_lo[i, :], mv_hi[i, :],
                  scores[k, :], zeros, zeros, zeros, zeros)
            st = jax.lax.fori_loop(0, W // UNROLL, group, st)
            for ref, v in zip(planes, st[:4]):
                ref[i, :] = v
            scores[k, :] = st[4]
            return st[5:]

        # the full variant stores every row's state for every column;
        # the score variant visits only the tile's live band
        lo, hi = (0, EBB) if FULL else (jnp.min(first), jnp.max(last) + 1)
        jax.lax.fori_loop(lo, hi, row, (ones, ones, zeros, zeros))

        # captures: window rows first+1, last-1, last after the sweep
        at = [jnp.clip(r, 0, EBB - 1) for r in (first + 1, last - 1, last)]

        def capture(j, caps):
            v = scores[nb + j, :]
            return tuple(jnp.where(j == a, v, c) for a, c in zip(at, caps))

        zi = jnp.zeros((LANES,), I32)
        c_first1, c_last1, c_last = jax.lax.fori_loop(0, EBB, capture,
                                                      (zi, zi, zi))
        do_shift, first_n, last_n = _band_cut(first, last, c_first1,
                                              c_last1, nb, consts, FULL)

        def shift(j, c):
            # ascending in place: row j takes row j+1 before it changes
            nxt = jnp.minimum(j + 1, EBB - 1)
            move = do_shift & (j >= first_n) & (j < last)
            top = do_shift & (j == last)
            for q, (ref, reset) in enumerate(zip(planes, resets)):
                v = jnp.where(move, ref[nxt, :], ref[j, :])
                v = jnp.where(top, reset, v)
                ref[j, :] = v
                if FULL:    # the stored 64th column is the shifted one
                    mats[q][nb * W + W - 1, j, :] = v
            return c

        jax.lax.fori_loop(0, EBB, shift, ())

        def write_score(j, c):
            k = nb + j
            scores[k, :] = jnp.where(do_shift & (j == last + 1), c_last + W,
                                     scores[k, :])
            return c

        jax.lax.fori_loop(0, EBB + 1, write_score, ())
        new_k = nb + 1 + EBB
        scores[new_k, :] = (new_k - prolog + 1) * W
        return first_n, last_n

    first, last = jax.lax.fori_loop(0, NB, block,
                                    (first0_r[...], last0_r[...]))
    first_o[...] = first
    last_o[...] = last


@partial(jax.jit, static_argnames=("EBB", "NB", "full", "lanes",
                                   "interpret"))
def banded_triton_call(peq_lo, peq_hi, lm_lo, lm_hi, text, init_scores,
                       cutoff, prolog, nbr, finish_v, tfinish, first0, last0,
                       *, EBB: int, NB: int, full: bool, lanes: int,
                       interpret: bool = False):
    """The kernel on lane-last arrays whose lane count B is a multiple
    of `lanes`; text is (NB*64, B) characters 0..4 of any integer type.
    Returns the reference's output dict (banded_jax.banded_scan_impl)."""
    B = text.shape[1]
    text_packed = pack_text(text)
    K = NB + EBB
    T = NB * W
    grid = (B // lanes,)
    vec = pl.BlockSpec((lanes,), lambda p: (p,))

    def rows(*shape):
        zs = (0,) * len(shape)
        return pl.BlockSpec(shape + (lanes,), lambda p: zs + (p,))

    in_specs = [rows(K, 5), rows(K, 5), rows(K), rows(K), rows(NB * WORDS),
                rows(EBB + 1)] + [vec] * 7
    out_shape = [jax.ShapeDtypeStruct((K + 1, B), I32)] + \
        [jax.ShapeDtypeStruct((EBB, B), U32)] * 4 + \
        [jax.ShapeDtypeStruct((B,), I32)] * 2
    out_specs = [rows(K + 1)] + [rows(EBB)] * 4 + [vec] * 2
    if full:
        out_shape += [jax.ShapeDtypeStruct((T, EBB, B), U32)] * 4
        out_specs += [rows(T, EBB)] * 4
    out = pl.pallas_call(
        partial(_kernel, EBB=EBB, NB=NB, FULL=full, LANES=lanes),
        out_shape=tuple(out_shape),
        grid=grid,
        in_specs=in_specs,
        out_specs=tuple(out_specs),
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, lanes // 32), num_stages=1),
        name="banded_full" if full else "banded_score",
    )(peq_lo, peq_hi, lm_lo, lm_hi, text_packed, init_scores, cutoff,
      prolog, nbr, finish_v, tfinish, first0, last0)
    names = OUT_NAMES + (MAT_NAMES if full else ())
    return dict(zip(names, out))


def tile_lanes(B: int) -> int:
    """Pairs per program: a power of two (Triton's block rule), at most
    TILE_MAX so a large batch spreads over many programs."""
    return min(TILE_MAX, max(TILE_MIN, 1 << max(B - 1, 0).bit_length()))


def pack_text(text):
    """(NB*64, B) chars 0..4 -> (NB*16, B) i32, 4 chars per word (char
    j of a block in byte j % 4 of word j // 4)."""
    n, B = text.shape
    t = text.reshape(n // 4, 4, B).astype(I32)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16) | (t[:, 3] << 24)


def stage(batch: BandedBatch):
    """Host padding + device transfer. Returns (args, statics) so
    callers can time or repeat the kernel without re-uploading."""
    B = batch.B
    lanes = tile_lanes(B)
    Bp = -(-B // lanes) * lanes

    def pad(a, fill=0):
        a = np.asarray(a)
        if a.shape[-1] == Bp:
            return a
        widths = [(0, 0)] * (a.ndim - 1) + [(0, Bp - a.shape[-1])]
        return np.pad(a, widths, constant_values=fill)

    host = (batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
            batch.text.astype(np.uint8), batch.init_scores)
    vecs = dict(cutoff=batch.cutoff, prolog=batch.prolog, nbr=batch.nbr,
                finish_v=batch.finish_v, tfinish=batch.tfinish,
                first0=batch.first0, last0=batch.last0)
    # inert geometry for pad lanes: an empty live range (first0 > last0),
    # so min(first)/max(last) over a tile ignore them, and tfinish 0
    fills = dict(cutoff=65, nbr=1, first0=batch.EBB - 1)
    args = [pad(a) for a in host] + \
        [pad(v, fills.get(k, 0)) for k, v in vecs.items()]
    statics = dict(EBB=batch.EBB, NB=batch.NB, full=batch.full,
                   lanes=lanes)
    return tuple(jax.device_put(a) for a in args), statics


def run_staged(args, statics, interpret: bool = False):
    """The kernel on staged device arrays; device outputs, lanes padded."""
    return banded_triton_call(*args, **statics, interpret=interpret)


def collect(out, B: int) -> dict:
    """One batched readback, pad lanes dropped."""
    host = jax.device_get(out)
    return {k: np.asarray(v)[..., :B] for k, v in host.items()}


def run_banded_triton(batch: BandedBatch, interpret: bool = False) -> dict:
    """Same contract as banded_jax.run_banded: a dict of host arrays."""
    args, statics = stage(batch)
    return collect(run_staged(args, statics, interpret), batch.B)


def banded_triton_impl(peq_lo, peq_hi, lm_lo, lm_hi, text, init_scores,
                       cutoff, prolog, nbr, finish_v, tfinish, first0,
                       last0, *, EBB: int, NB: int, full: bool,
                       interpret: bool = False):
    """Drop-in for banded_jax.banded_scan_impl (unpacked text) — the
    per-shard body of the sharded path. Programs take the largest
    power-of-two tile (at most TILE_MAX) that divides the lane count;
    the sharded wrapper pads shards to whole tiles."""
    B = text.shape[1]
    return banded_triton_call(
        peq_lo, peq_hi, lm_lo, lm_hi, text, init_scores,
        cutoff, prolog, nbr, finish_v, tfinish, first0, last0, EBB=EBB,
        NB=NB, full=full, lanes=min(TILE_MAX, B & -B), interpret=interpret)
