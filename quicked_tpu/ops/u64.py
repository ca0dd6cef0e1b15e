"""64-bit word emulation on 32-bit lanes.

The reference's Myers blocks are 64-bit words (bpm_commons.h:31-36). The
kernels carry every 64-bit word as an (lo, hi) pair of uint32 arrays
(native 64-bit words on the GPU are a later, measured change). All helpers are shape-polymorphic pure jnp functions and
work identically inside Pallas kernels and in plain XLA.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
# plain int, not a jnp array: module-level device constants get embedded
# into every traced jaxpr and force a device sync during lowering
ONES = 0xFFFFFFFF


def ones_like(x):
    return jnp.full_like(x, ONES)


def add64(alo, ahi, blo, bhi):
    """64-bit add with carry between the halves (wrapping)."""
    slo = alo + blo
    carry = (slo < alo).astype(U32)
    shi = ahi + bhi + carry
    return slo, shi


def advance_block64(eq_lo, eq_hi, mask_lo, mask_hi,
                    pv_lo, pv_hi, mv_lo, mv_hi, phin, mhin):
    """Myers advance-block on emulated 64-bit words
    (BPM_ADVANCE_BLOCK, bpm_commons.h:49-68).

    phin/mhin are 0/1 uint32 carries entering bit 0.
    Returns (pv_lo, pv_hi, mv_lo, mv_hi, phout, mhout).
    """
    xv_lo = eq_lo | mv_lo
    xv_hi = eq_hi | mv_hi
    _eq_lo = eq_lo | mhin
    _eq_hi = eq_hi
    t_lo = _eq_lo & pv_lo
    t_hi = _eq_hi & pv_hi
    s_lo, s_hi = add64(t_lo, t_hi, pv_lo, pv_hi)
    xh_lo = (s_lo ^ pv_lo) | _eq_lo
    xh_hi = (s_hi ^ pv_hi) | _eq_hi
    ph_lo = mv_lo | ~(xh_lo | pv_lo)
    ph_hi = mv_hi | ~(xh_hi | pv_hi)
    mh_lo = pv_lo & xh_lo
    mh_hi = pv_hi & xh_hi
    phout = (((ph_lo & mask_lo) | (ph_hi & mask_hi)) != 0).astype(U32)
    mhout = (((mh_lo & mask_lo) | (mh_hi & mask_hi)) != 0).astype(U32)
    # 64-bit shift left by one with carry-in
    ph_hi = (ph_hi << 1) | (ph_lo >> 31)
    ph_lo = (ph_lo << 1) | phin
    mh_hi = (mh_hi << 1) | (mh_lo >> 31)
    mh_lo = (mh_lo << 1) | mhin
    pv_lo_n = mh_lo | ~(xv_lo | ph_lo)
    pv_hi_n = mh_hi | ~(xv_hi | ph_hi)
    mv_lo_n = ph_lo & xv_lo
    mv_hi_n = ph_hi & xv_hi
    return pv_lo_n, pv_hi_n, mv_lo_n, mv_hi_n, phout, mhout


def _shr32(x, n):
    """x >> n on uint32 lanes with vector amounts; n outside [0,31] -> 0."""
    n = n.astype(jnp.int32) if hasattr(n, "astype") else jnp.int32(n)
    amt = jnp.clip(n, 0, 31).astype(U32)
    return jnp.where((n >= 0) & (n < 32), x >> amt, jnp.uint32(0))


def _shl32(x, n):
    """x << n on uint32 lanes with vector amounts; n outside [0,31] -> 0."""
    n = n.astype(jnp.int32) if hasattr(n, "astype") else jnp.int32(n)
    amt = jnp.clip(n, 0, 31).astype(U32)
    return jnp.where((n >= 0) & (n < 32), x << amt, jnp.uint32(0))


def shr64(lo, hi, s):
    """Logical right shift of a 64-bit (lo, hi) word by vector s in [0,63]."""
    lo_new = _shr32(lo, s) | _shl32(hi, 32 - s) | _shr32(hi, s - 32)
    hi_new = _shr32(hi, s)
    return lo_new, hi_new


def shl64(lo, hi, s):
    """Logical left shift of a 64-bit (lo, hi) word by vector s in [0,63]."""
    hi_new = _shl32(hi, s) | _shr32(lo, 32 - s) | _shl32(lo, s - 32)
    lo_new = _shl32(lo, s)
    return lo_new, hi_new


def funnel_shift_right(lo0, hi0, lo1, hi1, s):
    """(word1:word0) >> s restricted to 64 bits: the shifted PEQ window
    build (bpm_windowed.c:237-244): (w0 >> s) | (w1 << (64-s)), s in
    [0,63]; s == 0 returns w0."""
    a_lo, a_hi = shr64(lo0, hi0, s)
    b_lo, b_hi = shl64(lo1, hi1, (64 - s) % 64)
    is0 = s == 0
    lo = jnp.where(is0, lo0, a_lo | b_lo)
    hi = jnp.where(is0, hi0, a_hi | b_hi)
    return lo, hi


def bit64(lo, hi, idx):
    """Extract bit `idx` (vector, [0,63]) of (lo, hi) as uint32 0/1."""
    lo_bit = _shr32(lo, idx) & jnp.uint32(1)
    hi_bit = _shr32(hi, idx - 32) & jnp.uint32(1)
    return jnp.where(idx < 32, lo_bit, hi_bit)


def select_eq(char_enc, peq_block_lo, peq_block_hi):
    """Per-lane 5-way PEQ select: peq_block_* have a leading alphabet axis
    of size 5; char_enc is an int32 lane vector."""
    eq_lo = peq_block_lo[0]
    eq_hi = peq_block_hi[0]
    for c in range(1, 5):
        sel = char_enc == c
        eq_lo = jnp.where(sel, peq_block_lo[c], eq_lo)
        eq_hi = jnp.where(sel, peq_block_hi[c], eq_hi)
    return eq_lo, eq_hi
