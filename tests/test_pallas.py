"""Parity: the Pallas-Triton BandEd kernel (interpret mode) vs the XLA
scan kernel and the exact model.

Interpret mode runs the kernel's own dataflow on the CPU; the compiled
kernel is checked on the card by chip_smoke.py and the `gpu`-marked
tests (tests/test_gpu.py).
"""

import numpy as np

from quicked_tpu import generate
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.banded_triton import TILE_MIN, run_banded_triton
from quicked_tpu.ops.batch_prep import prepare_banded_batch


def _pairs(n, length, error, seed, length_diff=1.0):
    return list(generate.generate_pairs(n, length, error=error, seed=seed,
                                        length_diff=length_diff))


def test_pallas_banded_score_parity_interpret():
    pairs = _pairs(6, 200, 0.1, 1) + _pairs(2, 300, 0.15, 2, 1.2)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 40 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False)
    seq = run_banded(batch)
    pal = run_banded_triton(batch, interpret=True)
    assert set(pal) == set(seq)
    for k in pal:
        np.testing.assert_array_equal(seq[k], pal[k], err_msg=k)


def test_pallas_banded_full_parity_interpret():
    """Full-matrix variant: every stored band column must equal the XLA
    scan's snapshots."""
    pairs = _pairs(5, 200, 0.12, 7) + _pairs(2, 300, 0.2, 8, 1.15)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=True)
    seq = run_banded(batch)
    pal = run_banded_triton(batch, interpret=True)
    assert set(pal) == set(seq)
    for k in seq:
        np.testing.assert_array_equal(seq[k], pal[k], err_msg=k)


def test_pallas_full_traceback_matches_model():
    """The kernel's (T, EBB, B) planes walked by the host traceback."""
    from quicked_tpu.ops import myers_np
    from quicked_tpu.ops.traceback_np import banded_traceback_batch

    pairs = _pairs(4, 180, 0.15, 9)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [70] * 4
    batch = prepare_banded_batch(pats, txts, cutoffs, full=True)
    pal = run_banded_triton(batch, interpret=True)
    ops = banded_traceback_batch(
        pal["mat_pv_lo"], pal["mat_pv_hi"], pal["mat_mv_lo"],
        pal["mat_mv_hi"], list(range(4)), [p.encode() for p in pats],
        [t.encode() for t in txts],
        [int(batch.prolog[j]) for j in range(4)])
    for i in range(4):
        _, expect = myers_np.banded_align(pats[i], txts[i],
                                          int(cutoffs[i]))
        assert ops[i] == expect


def test_pallas_full_device_traceback_matches_model():
    """The on-device traceback lane (fill + column-scan walk, planes
    never leave the device): scores and CIGARs vs the exact model."""
    from quicked_tpu.aligner.batch import _raw_bytes, _run_device_full_tb
    from quicked_tpu.ops import myers_np

    pairs = _pairs(4, 180, 0.15, 9) + _pairs(2, 120, 0.05, 10, 1.2)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=True)
    praws = [_raw_bytes(p).tobytes() for p in pats]
    traws = [_raw_bytes(t).tobytes() for t in txts]
    sc, ops = _run_device_full_tb(batch, praws, traws, len(pairs),
                                  interpret=True)
    for i in range(len(pairs)):
        exp_sc, expect = myers_np.banded_align(pats[i], txts[i],
                                               int(cutoffs[i]))
        assert ops[i] == expect, i
        assert sc[i] == exp_sc, i


def test_pallas_lane_padding():
    # fewer pairs than one lane tile: padding must not disturb results
    pairs = _pairs(3, 150, 0.1, 3)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [60] * 3
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False)
    assert batch.B < TILE_MIN
    seq = run_banded(batch)
    pal = run_banded_triton(batch, interpret=True)
    np.testing.assert_array_equal(seq["scores_by_k"], pal["scores_by_k"])
    assert pal["scores_by_k"].shape == seq["scores_by_k"].shape
