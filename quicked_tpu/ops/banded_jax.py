"""Batched banded Myers kernels as pure-JAX scans.

Bit-exact batch re-expression of the reference banded kernels
(bpm_banded.c:199-316 full / 791-964 score-only): every pair occupies one
lane; 64-bit Myers blocks are (lo, hi) uint32 pairs; the band's dynamic
cut/shift state (first/last block, per 64 columns) is carried as lane
vectors. Runs on any JAX backend and is the plain reference that the
GPU kernel in banded_triton.py is tested against.

Band frame: shifted row k = column_block + band_block indexes the
host-prepared PEQ (see batch_prep.py), making all memory access uniform
across lanes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from quicked_tpu.ops import u64
from quicked_tpu.ops.batch_prep import BandedBatch

W = 64
U32 = jnp.uint32
I32 = jnp.int32


def _column_update(pv, mv, peq_win, lm_win, scw, char_enc, col_active,
                   first, last, EBB):
    """Advance one text column across all band blocks (carry chain).

    pv/mv: tuples (lo, hi) of (EBB, B) u32. scw: (EBB+1, B) i32 scores
    window. Returns updated state + edge-score captures.
    """
    B = char_enc.shape[0]
    zeros = jnp.zeros((B,), U32)
    c_first1 = jnp.zeros((B,), I32)
    c_last1 = jnp.zeros((B,), I32)
    c_last = jnp.zeros((B,), I32)

    def body(carry, xs):
        phin, mhin, c_first1, c_last1, c_last = carry
        (pv_lo, pv_hi, mv_lo, mv_hi, peq_lo, peq_hi, lm_lo, lm_hi,
         srow, i) = xs
        active = col_active & (i >= first) & (i <= last)
        is_first = i == first
        phin_eff = jnp.where(is_first, jnp.ones((B,), U32), phin)
        mhin_eff = jnp.where(is_first, zeros, mhin)
        eq_lo, eq_hi = u64.select_eq(char_enc, peq_lo, peq_hi)
        npv_lo, npv_hi, nmv_lo, nmv_hi, phout, mhout = u64.advance_block64(
            eq_lo, eq_hi, lm_lo, lm_hi, pv_lo, pv_hi, mv_lo, mv_hi,
            phin_eff, mhin_eff)
        pv_lo = jnp.where(active, npv_lo, pv_lo)
        pv_hi = jnp.where(active, npv_hi, pv_hi)
        mv_lo = jnp.where(active, nmv_lo, mv_lo)
        mv_hi = jnp.where(active, nmv_hi, mv_hi)
        srow_new = jnp.where(active,
                             srow + phout.astype(I32) - mhout.astype(I32),
                             srow)
        c_first1 = jnp.where(active & (i == first + 1), srow_new, c_first1)
        c_last1 = jnp.where(active & (i == last - 1), srow_new, c_last1)
        c_last = jnp.where(active & (i == last), srow_new, c_last)
        return ((phout, mhout, c_first1, c_last1, c_last),
                (pv_lo, pv_hi, mv_lo, mv_hi, srow_new))

    i_idx = jnp.arange(EBB, dtype=I32)
    xs = (pv[0], pv[1], mv[0], mv[1], peq_win[0], peq_win[1],
          lm_win[0], lm_win[1], scw[:EBB], i_idx)
    carry0 = (jnp.ones((B,), U32), zeros, c_first1, c_last1, c_last)
    carry, ys = jax.lax.scan(body, carry0, xs)
    _, _, c_first1, c_last1, c_last = carry
    pv_lo, pv_hi, mv_lo, mv_hi, srows = ys
    scw = jnp.concatenate([srows, scw[EBB:]], axis=0)
    return (pv_lo, pv_hi), (mv_lo, mv_hi), scw, (c_first1, c_last1, c_last)


def _band_cut(first, last, c_first1, c_last1, nb, batch_consts,
              full_variant):
    """The lane-vector decisions of the band cut/shift every 64 columns
    (bpm_banded.c:264-301 full / 889-922 score-only). Returns
    (do_shift, new first, new last). The shift itself moves rows
    [new first, old last) down by one and resets row old last; every
    kernel applies it in its own layout from these decisions."""
    cutoff, prolog, nbr, finish_v, tfinish = batch_consts
    do_shift = (nb + 1) * W <= tfinish
    pos_h = nb

    cut_lower = (first + 2 < last) & (finish_v > W * (first + 1)) & \
        ((c_first1 + (finish_v - W * (first + 1))) > cutoff)
    inc = do_shift & cut_lower & (pos_h >= prolog)
    dec = do_shift & (~cut_lower) & (pos_h < prolog)
    first = first + inc.astype(I32) - dec.astype(I32)

    cut_higher = (first + 2 < last) & (W * (last - 1) > finish_v) & \
        ((c_last1 + (W * (last - 1) - finish_v)) > cutoff)
    clamp_at = nbr - 1 if full_variant else nbr
    clamp = (nb - prolog + last) >= clamp_at
    last_n = last - (do_shift & (cut_higher | clamp)).astype(I32)
    return do_shift, first, last_n


def _maintenance(pv, mv, scw, first, last, captures, nb, batch_consts, EBB,
                 full_variant):
    """Band cut/shift every 64 columns
    (bpm_banded.c:264-301 full / 889-922 score-only)."""
    c_first1, c_last1, c_last = captures
    do_shift, first, last_n = _band_cut(first, last, c_first1, c_last1, nb,
                                        batch_consts, full_variant)

    j_idx = jax.lax.broadcasted_iota(I32, (EBB, 1), 0)
    m_shift = do_shift[None, :] & (j_idx >= first[None, :]) & \
        (j_idx < last[None, :])
    m_top = do_shift[None, :] & (j_idx == last[None, :])

    def shift(arr, top_val):
        rolled = jnp.roll(arr, -1, axis=0)
        arr = jnp.where(m_shift, rolled, arr)
        return jnp.where(m_top, top_val, arr)

    pv = (shift(pv[0], jnp.uint32(0xFFFFFFFF)), shift(pv[1], jnp.uint32(0xFFFFFFFF)))
    mv = (shift(mv[0], jnp.uint32(0)), shift(mv[1], jnp.uint32(0)))

    # scores[last + pos_v + 1] = scores[last + pos_v] + 64 → window row last+1
    w_idx = jax.lax.broadcasted_iota(I32, (EBB + 1, 1), 0)
    m_write = do_shift[None, :] & (w_idx == (last + 1)[None, :])
    scw = jnp.where(m_write, (c_last + W)[None, :], scw)

    # NOTE on the c_last capture: it is masked by the live range
    # [first, last], so it would read 0 if a lane ever reached
    # first > last while do_shift held. The band geometry makes that
    # unreachable (cutoff >= |Δlen|+1 couples NB/nbr/prolog so clamp
    # only trims the trailing blocks; fuzzed across extreme
    # length-ratio/cutoff regimes against kernels that read
    # scw[clip(last)] directly, with zero divergence).
    return pv, mv, scw, first, last_n


def banded_scan_impl(peq_lo, peq_hi, lm_lo, lm_hi, text, init_scores,
                     cutoff, prolog, nbr, finish_v, tfinish, first0, last0,
                     *, EBB: int, NB: int, full: bool):
    """Unjitted scan body — shared by the single-chip jit wrapper below
    and the shard_map data-parallel path (parallel/mesh.py)."""
    B = text.shape[1]
    batch_consts = (cutoff, prolog, nbr, finish_v, tfinish)
    text_blocks = text.reshape(NB, W, B)

    pv0 = (jnp.full((EBB, B), 0xFFFFFFFF, U32),) * 2
    mv0 = (jnp.zeros((EBB, B), U32),) * 2

    def outer(carry, xs):
        pv, mv, scw, first, last = carry
        nb, tblock = xs
        # per-block PEQ layout for the scan over blocks: (EBB, 5, B)
        peq_win = (jax.lax.dynamic_slice(peq_lo, (nb, 0, 0), (EBB, 5, B)),
                   jax.lax.dynamic_slice(peq_hi, (nb, 0, 0), (EBB, 5, B)))
        lm_win = (jax.lax.dynamic_slice(lm_lo, (nb, 0), (EBB, B)),
                  jax.lax.dynamic_slice(lm_hi, (nb, 0), (EBB, B)))

        def col(carry, xs):
            pv, mv, scw, captures = carry
            j, chars = xs
            t_global = nb * W + j
            col_active = t_global < tfinish
            pv, mv, scw, captures = _column_update(
                pv, mv, peq_win, lm_win, scw, chars, col_active,
                first, last, EBB)
            snap = (pv[0], pv[1], mv[0], mv[1]) if full else ()
            return (pv, mv, scw, captures), snap

        cap0 = (jnp.zeros((B,), I32),) * 3
        (pv, mv, scw, captures), snaps = jax.lax.scan(
            col, (pv, mv, scw, cap0),
            (jnp.arange(W, dtype=I32), tblock))
        pv, mv, scw, first, last = _maintenance(
            pv, mv, scw, first, last, captures, nb, batch_consts, EBB, full)
        dropped = scw[0]
        new_k = nb + 1 + EBB
        new_row = ((new_k - prolog + 1) * W).astype(I32)
        scw = jnp.concatenate([scw[1:], new_row[None, :]], axis=0)
        if full:
            # the stored 64th column must reflect the shifted state
            # (bpm_banded.c:279-287 operate on the stored column)
            snaps = tuple(s.at[W - 1].set(v)
                          for s, v in zip(snaps, (pv[0], pv[1], mv[0], mv[1])))
        ys = (dropped,) + (snaps if full else ())
        return (pv, mv, scw, first, last), ys

    carry0 = (pv0, mv0, init_scores, first0, last0)
    carry, ys = jax.lax.scan(outer, carry0,
                             (jnp.arange(NB, dtype=I32), text_blocks))
    pv, mv, scw, first, last = carry
    dropped = ys[0]
    scores_by_k = jnp.concatenate([dropped, scw], axis=0)  # (NB+EBB+1, B)
    out = dict(scores_by_k=scores_by_k,
               pv_lo=pv[0], pv_hi=pv[1], mv_lo=mv[0], mv_hi=mv[1],
               first=first, last=last)
    if full:
        # (NB, 64, EBB, B) -> (NB*64, EBB, B); column c holds the state
        # after processing text column c (reference column index c+1).
        mats = [y.reshape(NB * W, EBB, B) for y in ys[1:]]
        out.update(mat_pv_lo=mats[0], mat_pv_hi=mats[1],
                   mat_mv_lo=mats[2], mat_mv_hi=mats[3])
    return out


_banded_scan = partial(jax.jit, static_argnames=("EBB", "NB", "full"))(
    banded_scan_impl)


def run_banded(batch: BandedBatch, backend: str = "jax"):
    """Execute the banded kernel for a prepared batch; returns a dict of
    host numpy arrays."""
    args = [batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
            batch.text, batch.init_scores, batch.cutoff, batch.prolog,
            batch.nbr, batch.finish_v, batch.tfinish, batch.first0,
            batch.last0]
    out = _banded_scan(*[jnp.asarray(a) for a in args],
                       EBB=batch.EBB, NB=batch.NB, full=batch.full)
    return jax.device_get(out)  # one batched transfer for the dict
