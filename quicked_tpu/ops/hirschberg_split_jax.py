"""Device-side Hirschberg midpoint epilogue.

A batched jnp re-expression of `myers_np.hirschberg_split_fast`
(itself bit-exact with the reference's hirschberg_compute_score_row /
split search, bpm_hirschberg.c:149-200): given the forward and reverse
half-pass band states of each lane, compute (pattern_len_left,
score_l, score_r, feasible) per lane entirely on device.

Purpose: when the Hirschberg levels run on the device kernels, fusing
this epilogue after the score kernel (aligner/batch.py _hsplit_fused,
parallel/mesh.py run_level_splits_sharded) drops the per-level
device->host readback from O(band planes) to O(lanes). Bit-exact vs the
numpy spec on randomized geometries (tests/test_hirschberg_split_jax.py).

Semantics notes (all mirrored from the spec):
- the cell range is data-dependent (n_cells); the static bound is
  EBB*64 + 64 cells with masked tails (+inf outside the live range so
  jnp.argmin keeps the spec's FIRST-minimum tie-break);
- out-of-range band words read as reset state (Pv=1 -> step +1);
- score rows outside the kernel's score window fall back to the init
  formula (row+1)*64, which equals the padded rows' contents.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

I32 = jnp.int32
W = 64


@partial(jax.jit, static_argnames=("EBB",))
def hirschberg_split_batch(pv_lo, pv_hi, mv_lo, mv_hi,
                           f_first, f_last, f_scores,
                           r_pv_lo, r_pv_hi, r_mv_lo, r_mv_hi,
                           r_first, r_last, r_scores,
                           prolog, ebb, plen, tlen, *, EBB: int):
    """Vectorised Hirschberg split over (EBB, B) u32 band planes.

    f_*/r_*: forward/reverse half-pass kernel outputs; f_scores and
    r_scores are the (K+1, B) shifted-row score windows; prolog/ebb/
    plen/tlen are (B,) per-lane scalars (fwd and rev share geometry:
    the reversed pair has the same lengths and cutoff).

    Returns (pattern_len_left, score_l, score_r, feasible), each (B,).
    Lanes with feasible=False carry unspecified split values (the
    caller maps them to QUICKED_FAIL_NON_CONVERGENCE, like the spec's
    None).
    """
    NC = EBB * W + W                       # static bound on n_cells
    text_mid = (tlen + 1) // 2
    text_mid_r = tlen - text_mid
    fb_pos_v = jnp.where(text_mid < prolog * W, 0,
                         text_mid // W - prolog)
    fb_pos_v_r = jnp.where(text_mid_r < prolog * W, 0,
                           text_mid_r // W - prolog)

    bottom_pos = f_first * W + 63 + fb_pos_v * W
    bottom_pos_r = (plen - 1) - (r_last * W + 63 + fb_pos_v_r * W)
    higher_pos = f_last * W + 63 + fb_pos_v * W
    higher_pos_r = (plen - 1) - (r_first * W + 63 + fb_pos_v_r * W)
    feasible = ~((bottom_pos > higher_pos_r) | (bottom_pos_r > higher_pos))

    use_f_bottom = bottom_pos > bottom_pos_r
    bottom_cell = jnp.where(use_f_bottom, f_first * W + 63,
                            bottom_pos_r - fb_pos_v * W)
    starting_pos = jnp.where(use_f_bottom, bottom_pos, bottom_pos_r)
    use_f_high = higher_pos < higher_pos_r
    higher_cell = jnp.where(use_f_high, f_last * W + 63,
                            higher_pos_r - fb_pos_v * W)
    higher_cell_r = jnp.where(use_f_high,
                              (plen - 1) - higher_pos - fb_pos_v_r * W,
                              r_first * W + 63)
    n_cells = higher_cell - bottom_cell + 2

    steps = jnp.arange(NC, dtype=I32)[:, None]            # (NC, 1)

    def cell_cumsum(plo, phi, mlo, mhi, start):
        idx = start[None, :] + steps                      # (NC, B)
        blocks = idx >> 6          # arithmetic shift == floor, like //
        cells = idx & 63           # two's-complement & == Python's %
        ok = (blocks >= 0) & (blocks < ebb[None, :])
        blk = jnp.clip(blocks, 0, EBB - 1)
        lo_w = jnp.take_along_axis(plo, blk, axis=0)
        hi_w = jnp.take_along_axis(phi, blk, axis=0)
        mlo_w = jnp.take_along_axis(mlo, blk, axis=0)
        mhi_w = jnp.take_along_axis(mhi, blk, axis=0)
        low = cells < 32
        c_lo = jnp.where(low, cells, 0).astype(jnp.uint32)
        c_hi = jnp.where(low, 0, cells - 32).astype(jnp.uint32)
        one = jnp.uint32(1)
        pv_b = jnp.where(low, (lo_w >> c_lo) & one,
                         (hi_w >> c_hi) & one).astype(I32)
        mv_b = jnp.where(low, (mlo_w >> c_lo) & one,
                         (mhi_w >> c_hi) & one).astype(I32)
        # out-of-range words: reset-value semantics (Pv=1, Mv=0)
        step = jnp.where(ok, pv_b - mv_b, 1)
        cs = jnp.cumsum(step, axis=0)
        return jnp.concatenate([jnp.zeros((1, step.shape[1]), I32), cs],
                               axis=0)                    # (NC+1, B)

    cs = cell_cumsum(pv_lo, pv_hi, mv_lo, mv_hi, bottom_cell)
    csr = cell_cumsum(r_pv_lo, r_pv_hi, r_mv_lo, r_mv_hi, higher_cell_r)

    # joint[i] = csr[n_cells - 1 - i] + cs[i], first argmin over
    # i < n_cells (masked tails are +inf-like so they never win)
    r_idx = jnp.clip(n_cells[None, :] - 1 - steps, 0, NC)
    joint = jnp.take_along_axis(csr, r_idx, axis=0) + cs[:NC]
    joint = jnp.where(steps < n_cells[None, :], joint,
                      jnp.int32(2 ** 30))
    smaller_pos = jnp.argmin(joint, axis=0).astype(I32)
    pll = starting_pos + smaller_pos

    def cs_at(arr, idx):
        # the spec's deterministic clamp of the reference's OOB reads
        idxc = jnp.clip(idx, 0, n_cells)
        return jnp.take_along_axis(arr, idxc[None, :], axis=0)[0]

    def score_row(sk, row):
        # scores_k row (row + prolog); absent rows = (row + 1) * 64
        k1 = sk.shape[0]
        r = row + prolog
        inb = (r >= 0) & (r < k1)
        rc = jnp.clip(r, 0, k1 - 1)
        v = jnp.take_along_axis(sk, rc[None, :], axis=0)[0]
        return jnp.where(inb, v, (row + 1) * W)

    block_ref = (pll + W - 1) // W - \
        jnp.where(n_cells < smaller_pos + W, 1, 0)
    score_pos_l = block_ref * W - (bottom_cell + fb_pos_v * W)
    score_l = cs_at(cs, smaller_pos) - cs_at(cs, score_pos_l) + \
        score_row(f_scores, block_ref - 1)

    plr = plen - pll
    block_ref_r = (plr + W - 1) // W - jnp.where(smaller_pos < W, 1, 0)
    score_pos_r = block_ref_r * W - (higher_cell_r + fb_pos_v_r * W)
    score_r = cs_at(csr, n_cells - 1 - smaller_pos) - \
        cs_at(csr, score_pos_r) + score_row(r_scores, block_ref_r - 1)

    return pll, score_l, score_r, feasible


@partial(jax.jit, static_argnames=("EBB",))
def hsplit_epilogue_interleaved(scores, pv_lo, pv_hi, mv_lo, mv_hi,
                                first, last, prolog, plen, tlen, *,
                                EBB: int):
    """Split epilogue over an INTERLEAVED fwd/rev score batch (lanes
    [f0, r0, f1, r1, ...] — the layout that also keeps each task's two
    halves on one shard under lane sharding). Inputs are the score
    kernel's untiled outputs plus per-lane prolog / full pattern / full
    text lengths; returns per-task (pll, score_l, score_r, feasible)."""
    f = lambda a: a[..., 0::2]
    r = lambda a: a[..., 1::2]
    planes = (pv_lo, pv_hi, mv_lo, mv_hi)
    ebbv = jnp.full(f(first).shape, EBB, I32)
    return hirschberg_split_batch(
        *(f(p) for p in planes), f(first), f(last), f(scores),
        *(r(p) for p in planes), r(first), r(last), r(scores),
        f(prolog), ebbv, f(plen), f(tlen), EBB=EBB)
