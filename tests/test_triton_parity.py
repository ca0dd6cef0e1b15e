"""Interpret-mode parity of the Pallas-Triton score kernel against the
XLA scan (banded_jax) and the exact model (myers_np), over band depths
EBB 3..128 (powers of two and not), partial and multiple lane tiles,
inverted prologs (pattern longer than text), text longer than pattern,
Hirschberg midpoint stops (text_finish) and mixed lengths."""

import numpy as np
import pytest

from quicked_tpu import generate
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.banded_triton import run_banded_triton
from quicked_tpu.ops.batch_prep import extract_final_scores, \
    prepare_banded_batch

# (n, length, error, cutoff % of max length, length_diff, min_ebb,
#  text_finish fraction, expected EBB)
CASES = {
    "ebb3_tiny": (3, 100, 0.05, 15, 1.0, None, 1.0, 3),
    "ebb4_partial_tile": (19, 400, 0.1, 40, 1.0, None, 1.0, 4),
    "ebb6_inverted_prolog": (6, 300, 0.12, 90, 0.8, None, 1.0, 6),
    "ebb8_text_longer": (5, 250, 0.1, 130, 1.3, None, 1.0, 8),
    "ebb14_text_finish": (4, 800, 0.15, 100, 1.0, None, 0.5, 14),
    "ebb16_pow2": (7, 300, 0.1, 30, 1.0, 16, 1.0, 16),
    "ebb33_two_tiles": (40, 200, 0.1, 30, 1.0, 33, 1.0, 33),
    "ebb64": (3, 260, 0.2, 50, 1.1, 64, 1.0, 64),
    "ebb100_not_pow2": (3, 200, 0.1, 30, 1.0, 100, 0.6, 100),
    "ebb128_deepest_shallow": (2, 180, 0.1, 30, 0.9, 128, 1.0, 128),
}


def _batch(n, length, error, pct, ldiff, min_ebb, fin_frac, seed):
    pairs = list(generate.generate_pairs(n, length, error=error, seed=seed,
                                         length_diff=ldiff))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * pct // 100 for p, t in pairs]
    fins = [max(int(len(t) * fin_frac), 1) for t in txts]
    b = prepare_banded_batch(pats, txts, cos, full=False, text_finish=fins,
                             min_ebb=min_ebb)
    return b, pats, txts, cos, fins


@pytest.mark.parametrize("name", sorted(CASES))
def test_triton_score_parity(name):
    n, length, error, pct, ldiff, min_ebb, fin_frac, ebb = CASES[name]
    b, pats, txts, cos, fins = _batch(n, length, error, pct, ldiff,
                                      min_ebb, fin_frac,
                                      seed=sorted(CASES).index(name))
    assert b.EBB == ebb
    want = run_banded(b)
    got = run_banded_triton(b, interpret=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    if fin_frac == 1.0:
        sc = extract_final_scores(b, got["scores_by_k"])
        for i in range(n):
            ref = myers_np.banded_score(myers_np.compile_pattern(pats[i]),
                                        b.enc_texts[i], int(cos[i]))
            assert int(sc[i]) == ref.score, i


def test_triton_score_parity_mixed_lengths():
    """One batch of pairs of different lengths and length ratios (the
    bucketed shape the engine builds), each lane against the model."""
    pairs = (list(generate.generate_pairs(3, 90, error=0.1, seed=21))
             + list(generate.generate_pairs(3, 320, error=0.1, seed=22,
                                            length_diff=1.2))
             + list(generate.generate_pairs(3, 200, error=0.2, seed=23,
                                            length_diff=0.85)))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 25 // 100 for p, t in pairs]
    b = prepare_banded_batch(pats, txts, cos, full=False, pad_to_b=16)
    want = run_banded(b)
    got = run_banded_triton(b, interpret=True)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    sc = extract_final_scores(b, got["scores_by_k"])
    for i in range(len(pairs)):
        ref = myers_np.banded_score(myers_np.compile_pattern(pats[i]),
                                    b.enc_texts[i], int(cos[i]))
        assert int(sc[i]) == ref.score, i
