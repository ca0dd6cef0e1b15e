"""Deep-band BandEd kernel: block-parallel columns via a carry-map scan.

The sequential banded kernels walk a column's band blocks in order
because the Myers PHin/MHin carries chain block-to-block
(bpm_banded.c:830-886). For deep bands (EBB in the hundreds-to-
thousands, the ONT stage-3 regime) that chain is the whole problem: the
pairs-as-lanes kernels get only B lanes of parallelism, and the
reference's AVX2 answer — an anti-diagonal column pipeline
(bpm_banded.c:349-788) — fills only as many lanes as the pipeline is
deep.

Reformulation: the carry entering a block is one of THREE
states — P (PHin=1), Z (no carry), M (MHin=1) — and a block's carry-out
as a function of carry-in is a map {P,Z,M} -> {P,Z,M}. Crucially the P
and Z inputs produce the SAME carry-out (the injected low bit never
reaches the level mask within one advance), so each map is just a pair
(a, b) = (out for P/Z, out for M), and composition costs two selects.
Map composition is associative, so the per-column chain becomes:

  1. compute each block's advance for the Z and M carry-ins (the P
     result derives from Z in 3 ops: only bit 0 differs);
  2. build per-block maps, replace blocks below `first` with the
     constant-P map (the chain enters block `first` with PHin=1,
     bpm_banded.c:838);
  3. exclusive prefix-compose the maps (Hillis-Steele, log2(EBB)
     levels) — the resolved carry-in of every block at once;
  4. select each block's final state among the three variants.

All EBB blocks of a column advance in parallel — EBB-wide vector work
even at B = 1, at ~3x the arithmetic of one advance plus a log-depth
scan. Bit-exact: the resolved carries equal the sequential
chain's by construction (verified against banded_jax.run_banded).

This module is a pure-JAX drop-in for banded_scan_impl (score-only):
the GPU's deep-band device lane, priced against host C by the router.
On an H100 it ran 16 x 30 kbp at EBB 72 in 0.61 s against 1.51 s for
the anti-diagonal wavefront kernel it replaced. The element-wise core
(cscan_column) is layout-agnostic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from quicked_tpu.ops import u64
from quicked_tpu.ops.banded_jax import _maintenance
from quicked_tpu.ops.batch_prep import BandedBatch

W = 64
U32 = jnp.uint32
I32 = jnp.int32

# carry-state encoding
P_ST, Z_ST, M_ST = 0, 1, 2


def advance_variants(eq_lo, eq_hi, lm_lo, lm_hi, pv_lo, pv_hi,
                     mv_lo, mv_hi):
    """Myers advance for carry-ins Z=(0,0) and M=(0,1); derive P=(1,0)
    from Z (only bit 0 of the outputs differs; the carry-outs of P and
    Z are identical because the injected bit is below the level mask).

    Returns (Z_state, P_state, M_state, outZ, outM) where each state is
    (pv_lo, pv_hi, mv_lo, mv_hi) and out* = (phout, mhout) u32 0/1.
    """
    zero = jnp.zeros_like(pv_lo)
    one = jnp.ones_like(pv_lo)
    z = u64.advance_block64(eq_lo, eq_hi, lm_lo, lm_hi,
                            pv_lo, pv_hi, mv_lo, mv_hi, zero, zero)
    m = u64.advance_block64(eq_lo, eq_hi, lm_lo, lm_hi,
                            pv_lo, pv_hi, mv_lo, mv_hi, zero, one)
    z_pv_lo, z_pv_hi, z_mv_lo, z_mv_hi, z_pho, z_mho = z
    m_pv_lo, m_pv_hi, m_mv_lo, m_mv_hi, m_pho, m_mho = m
    # P from Z: Ph2 gains bit 0; Pv' bit0 -> Mh2_0 (=0), Mv' bit0 -> Xv_0
    xv_lo = eq_lo | mv_lo
    p_pv_lo = z_pv_lo & jnp.uint32(0xFFFFFFFE)
    p_mv_lo = (z_mv_lo & jnp.uint32(0xFFFFFFFE)) | (xv_lo & jnp.uint32(1))
    z_state = (z_pv_lo, z_pv_hi, z_mv_lo, z_mv_hi)
    p_state = (p_pv_lo, z_pv_hi, p_mv_lo, z_mv_hi)
    m_state = (m_pv_lo, m_pv_hi, m_mv_lo, m_mv_hi)
    return z_state, p_state, m_state, (z_pho, z_mho), (m_pho, m_mho)


def _out_state(pho, mho):
    """Carry-out encoding: P if PHout else M if MHout else Z."""
    return jnp.where(pho != 0, jnp.uint32(P_ST),
                     jnp.where(mho != 0, jnp.uint32(M_ST),
                               jnp.uint32(Z_ST)))


def compose_maps(af, bf, ag, bg):
    """(f o g): apply g, then f. f(P)=f(Z)=af, f(M)=bf."""
    a = jnp.where(ag == M_ST, bf, af)
    b = jnp.where(bg == M_ST, bf, af)
    return a, b


def cscan_column(eq, lm, pv, mv, blk_idx, first, last, col_act,
                 shiftdown, n_levels: int):
    """One text column over all band blocks in parallel.

    eq/lm/pv/mv: (lo, hi) tuples, all arrays of one common shape S whose
    elements are indexed by band-block via blk_idx (i32, shape S).
    first/last/col_act: broadcast to S. shiftdown(x, d, fill): shift
    x by d positions toward higher block index, filling vacated slots.
    n_levels: static Hillis-Steele level count (2**n_levels >= blocks).

    Returns (pv', mv', delta) with masking applied (inactive blocks keep
    their state; delta is 0 there).
    """
    z_st, p_st, m_st, (z_pho, z_mho), (m_pho, m_mho) = advance_variants(
        eq[0], eq[1], lm[0], lm[1], pv[0], pv[1], mv[0], mv[1])

    a = _out_state(z_pho, z_mho)
    b = _out_state(m_pho, m_mho)
    # blocks below `first` contribute the constant-P map (the chain
    # enters block `first` with PHin=1)
    below = blk_idx < first
    a = jnp.where(below, jnp.uint32(P_ST), a)
    b = jnp.where(below, jnp.uint32(P_ST), b)
    # exclusive prefix: inject constant-P at block 0, then inclusive scan
    a = shiftdown(a, 1, jnp.uint32(P_ST))
    b = shiftdown(b, 1, jnp.uint32(P_ST))
    for lev in range(n_levels):
        d = 1 << lev
        ag = shiftdown(a, d, jnp.uint32(P_ST))
        bg = shiftdown(b, d, jnp.uint32(P_ST))
        a, b = compose_maps(a, b, ag, bg)
    # the bottom of every prefix is constant-P, so the resolved carry-in
    # is the map's P/Z image
    r = a

    is_m = r == M_ST
    is_p = r == P_ST

    def pick(zv, pv_, mv_):
        return jnp.where(is_m, mv_, jnp.where(is_p, pv_, zv))

    act = col_act & (blk_idx >= first) & (blk_idx <= last)
    new_pv = (jnp.where(act, pick(z_st[0], p_st[0], m_st[0]), pv[0]),
              jnp.where(act, pick(z_st[1], p_st[1], m_st[1]), pv[1]))
    new_mv = (jnp.where(act, pick(z_st[2], p_st[2], m_st[2]), mv[0]),
              jnp.where(act, pick(z_st[3], p_st[3], m_st[3]), mv[1]))
    # P and Z share carry-outs, so the score delta needs only an M-select
    delta = jnp.where(is_m, m_pho.astype(I32) - m_mho.astype(I32),
                      z_pho.astype(I32) - z_mho.astype(I32))
    delta = jnp.where(act, delta, 0)
    return new_pv, new_mv, delta


def cscan_scan_impl(peq_lo, peq_hi, lm_lo, lm_hi, text, init_scores,
                    cutoff, prolog, nbr, finish_v, tfinish, first0, last0,
                    *, EBB: int, NB: int):
    """Score-only banded scan with the carry-map-parallel inner column.
    Same signature/returns as banded_jax.banded_scan_impl (full=False).
    """
    B = text.shape[1]
    batch_consts = (cutoff, prolog, nbr, finish_v, tfinish)
    text_blocks = text.reshape(NB, W, B)
    n_levels = max(int(np.ceil(np.log2(max(EBB, 2)))), 1)

    pv0 = (jnp.full((EBB, B), 0xFFFFFFFF, U32),) * 2
    mv0 = (jnp.zeros((EBB, B), U32),) * 2
    blk_idx = jax.lax.broadcasted_iota(I32, (EBB, B), 0)

    def shiftdown(x, d, fill):
        if d >= EBB:
            return jnp.full_like(x, fill)
        pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([pad, x[:-d]], axis=0)

    def outer(carry, xs):
        pv, mv, scw, first, last = carry
        nb, tblock = xs
        peq_win = (jax.lax.dynamic_slice(peq_lo, (nb, 0, 0), (EBB, 5, B)),
                   jax.lax.dynamic_slice(peq_hi, (nb, 0, 0), (EBB, 5, B)))
        lm_win = (jax.lax.dynamic_slice(lm_lo, (nb, 0), (EBB, B)),
                  jax.lax.dynamic_slice(lm_hi, (nb, 0), (EBB, B)))

        def col(carry, xs):
            pv, mv, scw, captures = carry
            j, chars = xs
            t_global = nb * W + j
            col_active = (t_global < tfinish)[None, :]
            # per-block 5-way PEQ select by the lane's text character
            eq_lo = peq_win[0][:, 0, :]
            eq_hi = peq_win[1][:, 0, :]
            for c in range(1, 5):
                sel = (chars == c)[None, :]
                eq_lo = jnp.where(sel, peq_win[0][:, c, :], eq_lo)
                eq_hi = jnp.where(sel, peq_win[1][:, c, :], eq_hi)
            pv, mv, delta = cscan_column(
                (eq_lo, eq_hi), lm_win, pv, mv, blk_idx,
                first[None, :], last[None, :], col_active,
                shiftdown, n_levels)
            srows = scw[:EBB] + delta
            scw = jnp.concatenate([srows, scw[EBB:]], axis=0)
            c_first1 = jnp.take_along_axis(
                srows, jnp.clip(first + 1, 0, EBB - 1)[None, :], axis=0)[0]
            c_last1 = jnp.take_along_axis(
                srows, jnp.clip(last - 1, 0, EBB - 1)[None, :], axis=0)[0]
            c_last = jnp.take_along_axis(
                srows, jnp.clip(last, 0, EBB - 1)[None, :], axis=0)[0]
            return (pv, mv, scw, (c_first1, c_last1, c_last)), ()

        cap0 = (jnp.zeros((B,), I32),) * 3
        (pv, mv, scw, captures), _ = jax.lax.scan(
            col, (pv, mv, scw, cap0),
            (jnp.arange(W, dtype=I32), tblock))
        pv, mv, scw, first, last = _maintenance(
            pv, mv, scw, first, last, captures, nb, batch_consts, EBB,
            full_variant=False)
        dropped = scw[0]
        new_k = nb + 1 + EBB
        new_row = ((new_k - prolog + 1) * W).astype(I32)
        scw = jnp.concatenate([scw[1:], new_row[None, :]], axis=0)
        return (pv, mv, scw, first, last), dropped

    carry0 = (pv0, mv0, init_scores, first0, last0)
    (pv, mv, scw, first, last), dropped = jax.lax.scan(
        outer, carry0, (jnp.arange(NB, dtype=I32), text_blocks))
    scores_by_k = jnp.concatenate([dropped, scw], axis=0)
    return dict(scores_by_k=scores_by_k,
                pv_lo=pv[0], pv_hi=pv[1], mv_lo=mv[0], mv_hi=mv[1],
                first=first, last=last)


_cscan_scan = partial(jax.jit, static_argnames=("EBB", "NB"))(
    cscan_scan_impl)


def run_banded_cscan(batch: BandedBatch):
    """Execute the carry-scan score-only kernel for a prepared batch."""
    assert not batch.full, "carry-scan kernel is score-only"
    args = [batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
            batch.text, batch.init_scores, batch.cutoff, batch.prolog,
            batch.nbr, batch.finish_v, batch.tfinish, batch.first0,
            batch.last0]
    out = _cscan_scan(*[jnp.asarray(a) for a in args],
                      EBB=batch.EBB, NB=batch.NB)
    return {k: np.asarray(v) for k, v in out.items()}
