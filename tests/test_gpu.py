"""Tests of the compiled kernels on the card (marker `gpu`; the `gpu`
fixture skips them where JAX has no GPU). Run them on a machine with
one: `python -m pytest tests/test_gpu.py -m gpu` (chip_smoke.py runs
them in its own process)."""

import numpy as np
import pytest

from quicked_tpu import generate

pytestmark = pytest.mark.gpu


def _pairs(n, length, error, seed):
    return generate.generate_pairs_bulk(n, length, error, seed=seed)


def test_compiled_score_kernel_matches_xla_scan(gpu):
    from quicked_tpu.ops.banded_jax import run_banded
    from quicked_tpu.ops.banded_triton import run_banded_triton
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    pairs = _pairs(3000, 2000, 0.12, 1) + list(generate.generate_pairs(
        37, 1500, error=0.1, seed=2, length_diff=1.3))
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [max(len(p), len(t)) * 20 // 100
                              for p, t in pairs], full=False)
    want = run_banded(b)
    got = run_banded_triton(b)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_compiled_full_fill_and_device_traceback_match_host_c(gpu):
    from quicked_tpu.aligner.batch import _run_device_full_tb
    from quicked_tpu.ops.banded_native import run_banded_full_native
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    pairs = _pairs(2000, 300, 0.05, 3)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    b = prepare_banded_batch(pats, txts, cos, full=True)
    sc, ops = _run_device_full_tb(b, [p.encode() for p in pats],
                                  [t.encode() for t in txts], len(pairs))
    want_sc, want_ops = run_banded_full_native(pats, txts, cos)
    assert [int(x) for x in sc] == [int(x) for x in want_sc]
    assert ops == want_ops


def test_compiled_fused_split_level_matches_spec(gpu):
    from quicked_tpu.aligner.batch import _hsplit_fused, banded_score_results
    from quicked_tpu.ops import myers_np
    from quicked_tpu.ops.batch_prep import prepare_banded_batch

    pairs = _pairs(48, 3000, 0.1, 4)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 25 // 100 for p, t in pairs]
    mids = [(len(t) + 1) // 2 for t in txts]
    mids_r = [len(t) - m for t, m in zip(txts, mids)]
    il = lambda a, b: [x for pair in zip(a, b) for x in pair]
    batch = prepare_banded_batch(
        il(pats, [p[::-1] for p in pats]), il(txts, [t[::-1] for t in txts]),
        il(cos, cos), full=False, text_finish=il(mids, mids_r))
    pll, sl, sr, ok = _hsplit_fused(batch)
    both = banded_score_results(pats + [p[::-1] for p in pats],
                                txts + [t[::-1] for t in txts],
                                cos + cos, text_finish=mids + mids_r)
    n = len(pairs)
    for j, (f, r) in enumerate(zip(both[:n], both[n:])):
        want = myers_np.hirschberg_split_fast(
            f.pv64, f.mv64, f.first, f.last, f.scores_k,
            r.pv64, r.mv64, r.first, r.last, r.scores_k,
            f.prolog, len(pats[j]), len(txts[j]))
        got = (int(pll[j]), int(sl[j]), int(sr[j])) if ok[j] else None
        assert got == want, j
