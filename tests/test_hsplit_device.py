"""Device-fused Hirschberg split levels (score kernel + epilogue on
device, O(tasks) readback) vs the numpy spec path — both single-device
(the Triton kernel in interpret mode) and sharded over a mesh."""

import numpy as np
import pytest

from quicked_tpu import generate
from quicked_tpu.ops import myers_np

W = 64


def _tasks(n, length, error, seed, ldiff=1.0):
    pairs = list(generate.generate_pairs(n, length, error=error, seed=seed,
                                         length_diff=ldiff))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(max(len(p), len(t)) * 25 // 100,
               abs(len(p) - len(t)) + 1) for p, t in pairs]
    mids = [(len(t) + 1) // 2 for t in txts]
    mids_r = [len(t) - m for t, m in zip(txts, mids)]
    return pats, txts, cos, mids, mids_r


def _spec_splits(pats, txts, cos, mids, mids_r):
    from quicked_tpu.aligner.batch import banded_score_results

    n = len(pats)
    both = banded_score_results(
        pats + [p[::-1] for p in pats],
        txts + [t[::-1] for t in txts],
        list(cos) + list(cos), text_finish=mids + mids_r)
    fwd, rev = both[:n], both[n:]
    return [myers_np.hirschberg_split_fast(
        f.pv64, f.mv64, f.first, f.last, f.scores_k,
        r.pv64, r.mv64, r.first, r.last, r.scores_k,
        f.prolog, len(pats[j]), len(txts[j]))
        for j, (f, r) in enumerate(zip(fwd, rev))]


def _interleaved_batch(pats, txts, cos, mids, mids_r, pad_to_b):
    from quicked_tpu.aligner.batch import _next_pow2
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    pats_il, txts_il, cos_il, fins_il = [], [], [], []
    for i in range(len(pats)):
        pats_il += [pats[i], pats[i][::-1]]
        txts_il += [txts[i], txts[i][::-1]]
        cos_il += [int(cos[i])] * 2
        fins_il += [int(mids[i]), int(mids_r[i])]
    geo = myers_np.band_geometry(len(pats[0]), len(txts[0]), int(cos[0]))
    ebb_p2 = _next_pow2(myers_np.div_ceil(geo.cutoff, W) + 1)
    nb_p2 = _next_pow2(max(myers_np.div_ceil(max(mids[0], mids_r[0]), W),
                           1))
    return prepare_banded_batch(pats_il, txts_il, cos_il, full=False,
                                text_finish=fins_il, pad_to_b=pad_to_b,
                                min_nb=nb_p2, min_ebb=ebb_p2)


@pytest.mark.parametrize("length,error,seed", [
    (500, 0.08, 3),
    (700, 0.2, 4),
])
def test_hsplit_fused_pallas_interpret_parity(length, error, seed):
    from quicked_tpu.aligner.batch import _hsplit_fused

    pats, txts, cos, mids, mids_r = _tasks(5, length, error, seed)
    want = _spec_splits(pats, txts, cos, mids, mids_r)
    batch = _interleaved_batch(pats, txts, cos, mids, mids_r, pad_to_b=16)
    pll, sl, sr, ok = _hsplit_fused(batch, interpret=True)
    for j, w in enumerate(want):
        if w is None:
            assert not ok[j], j
        else:
            assert ok[j], j
            assert (int(pll[j]), int(sl[j]), int(sr[j])) == w, j


def test_hsplit_mesh_parity():
    """The sharded fused level (run_level_splits_sharded) and the
    driver-facing hirschberg_level_splits_device under use_mesh must
    match the spec path exactly."""
    import jax

    from quicked_tpu.aligner.batch import hirschberg_level_splits_device
    from quicked_tpu.parallel.mesh import make_mesh, use_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    pats, txts, cos, mids, mids_r = _tasks(6, 600, 0.12, 7, ldiff=1.1)
    want = _spec_splits(pats, txts, cos, mids, mids_r)
    with use_mesh(make_mesh(8)):
        got = hirschberg_level_splits_device(pats, txts, cos, mids,
                                             mids_r)
    assert got is not None
    for j, w in enumerate(want):
        if w is None:
            assert got[j] is None, j
        else:
            assert got[j] == w, j


def test_hsplit_mesh_full_hirschberg_bit_exact():
    """End-to-end: hirschberg_batch under a mesh (now taking the fused
    device-split path) must match the spec recursion exactly."""
    import jax

    from quicked_tpu.aligner.hirschberg import hirschberg_batch
    from quicked_tpu.parallel.mesh import make_mesh, use_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    pairs = list(generate.generate_pairs(3, 900, error=0.1, seed=11))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 20 // 100 for p, t in pairs]
    # force two split levels on 900 bp pairs — in BOTH the driver and the spec
    # recursion (myers_np binds its own copy at import)
    import quicked_tpu.aligner.hirschberg as hb
    olds = (hb.HIRSCHBERG_BUFFER_SIZE, myers_np.HIRSCHBERG_BUFFER)
    hb.HIRSCHBERG_BUFFER_SIZE = 1 << 14
    myers_np.HIRSCHBERG_BUFFER = 1 << 14
    try:
        with use_mesh(make_mesh(8)):
            got = hirschberg_batch(txts, pats, cos)
    finally:
        hb.HIRSCHBERG_BUFFER_SIZE, myers_np.HIRSCHBERG_BUFFER = olds
    for j in range(len(pairs)):
        st, ops = myers_np.hirschberg(txts[j], pats[j], int(cos[j]))
        assert (got[j][0], got[j][1]) == (st, ops), j
