"""Parity: the carry-map-scan deep-band kernel vs the sequential scan.

banded_cscan_jax resolves each column's inter-block carry chain with an
associative 3-state map scan; it must match banded_jax.run_banded
bit-for-bit.
"""

import numpy as np
import pytest

from quicked_tpu import generate
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan
from quicked_tpu.ops.batch_prep import prepare_banded_batch

KEYS = ("scores_by_k", "pv_lo", "pv_hi", "mv_lo", "mv_hi", "first",
        "last")


def _batch(n, L, e, cutoff, seed, fins=None, ld=1.0):
    pairs = list(generate.generate_pairs(n, L, error=e, seed=seed,
                                         length_diff=ld))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    return prepare_banded_batch(pats, txts, [cutoff] * n, full=False,
                                text_finish=fins)


def _assert_same(a, b):
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cscan_jax_parity():
    for batch in [
        _batch(4, 300, 0.15, 120, 1),
        _batch(2, 1000, 0.2, 300, 2, ld=1.15),
        _batch(1, 4000, 0.25, 4000, 3),     # deep band
    ]:
        _assert_same(run_banded(batch), run_banded_cscan(batch))


@pytest.mark.parametrize("length,error,seed,ldiff,bw", [
    (200, 0.1, 1, 1.0, 40),
    (500, 0.15, 2, 1.0, 30),
    (300, 0.1, 3, 1.2, 40),
    (1000, 0.1, 4, 1.0, 15),
    (129, 0.2, 5, 0.8, 50),
])
def test_cscan_equals_sequential_bucketed(length, error, seed, ldiff, bw):
    """The engine's bucketed shapes (pow2 NB/EBB floors, padded lanes),
    unequal lengths both ways included."""
    pairs = list(generate.generate_pairs(4, length, error=error, seed=seed,
                                         length_diff=ldiff))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * bw // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False,
                                 min_nb=16, min_ebb=16, pad_to_b=8)
    _assert_same(run_banded(batch), run_banded_cscan(batch))


def test_cscan_text_finish_bucketed():
    pairs = list(generate.generate_pairs(3, 600, error=0.1, seed=8))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    fins = [len(t) // 2 for t in txts]
    batch = prepare_banded_batch(pats, txts, [90] * 3, full=False,
                                 text_finish=fins, min_nb=16, min_ebb=16,
                                 pad_to_b=8)
    _assert_same(run_banded(batch), run_banded_cscan(batch))


def test_cscan_jax_parity_half_pass():
    pairs = list(generate.generate_pairs(2, 2000, error=0.2, seed=5))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    fins = [len(t) // 2 for _, t in pairs]
    batch = prepare_banded_batch(pats, txts, [600] * 2, full=False,
                                 text_finish=fins)
    _assert_same(run_banded(batch), run_banded_cscan(batch))
