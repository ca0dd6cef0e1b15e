"""The Pallas-Triton full fill (interpret mode) feeding the on-device
traceback: CIGARs against the traceback spec (traceback_np) over the
same planes and against the exact model; the wrapper's lane tiles and
padding; the kernel as the per-shard body of the sharded path."""

from functools import partial

import numpy as np
import pytest

from quicked_tpu import generate
from quicked_tpu.ops import banded_triton as bt
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.ops.traceback_np import banded_traceback_pair

# (n, length, error, cutoff %, length_diff, pad_to_b)
FULL_CASES = {
    "short_reads_padded_tile": (5, 100, 0.02, 15, 1.0, None),
    "inverted_prolog": (4, 220, 0.12, 30, 0.85, 8),
    "text_longer_two_tiles": (20, 150, 0.1, 40, 1.2, 40),
}


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_triton_full_device_traceback_vs_spec(name):
    from quicked_tpu.aligner.batch import _run_device_full_tb

    n, length, error, pct, ldiff, pad = FULL_CASES[name]
    pairs = list(generate.generate_pairs(n, length, error=error, seed=40,
                                         length_diff=ldiff))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * pct // 100 for p, t in pairs]
    b = prepare_banded_batch(pats, txts, cos, full=True, pad_to_b=pad)
    planes = bt.run_banded_triton(b, interpret=True)
    sc, ops = _run_device_full_tb(b, [p.encode() for p in pats],
                                  [t.encode() for t in txts], n,
                                  interpret=True)
    for i in range(n):
        lane = [planes[k][:, :, i] for k in bt.MAT_NAMES]
        spec = banded_traceback_pair(
            *lane, np.frombuffer(pats[i].encode(), np.uint8),
            np.frombuffer(txts[i].encode(), np.uint8), int(b.prolog[i]))
        assert ops[i] == spec, i
        want_sc, want_ops = myers_np.banded_align(pats[i], txts[i], cos[i])
        assert (int(sc[i]), ops[i]) == (want_sc, want_ops), i


@pytest.mark.parametrize("B,lanes", [(1, 16), (16, 16), (17, 32), (32, 32),
                                     (5000, 32)])
def test_tile_lanes(B, lanes):
    assert bt.tile_lanes(B) == lanes
    assert lanes & (lanes - 1) == 0          # Triton: powers of two


def test_stage_pads_lanes_inert():
    """Pad lanes carry an empty live band and no text, so they never
    widen a tile's [min(first), max(last)] row range; text uploads one
    byte per char and packs 4 chars per word, round-tripping."""
    pairs = list(generate.generate_pairs(19, 130, error=0.1, seed=41))
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [40] * 19, full=False)
    args, st = bt.stage(b)
    assert st["lanes"] == 32 and args[0].shape[-1] == 32
    text, first0, last0, tfin = (np.asarray(args[i]) for i in (4, 11, 12,
                                                               10))
    assert np.all(first0[19:] == b.EBB - 1) and np.all(last0[19:] == 0)
    assert np.all(tfin[19:] == 0)
    assert text.dtype == np.uint8
    np.testing.assert_array_equal(text[:, :19], b.text)
    packed = np.asarray(bt.pack_text(text))
    assert packed.shape == (text.shape[0] // 4, 32)
    unpacked = packed.T.copy().view(np.uint8).reshape(32, -1).T
    np.testing.assert_array_equal(unpacked, text)


@pytest.mark.parametrize("full", [False, True])
def test_triton_as_sharded_body(full, monkeypatch):
    """The sharded path with the Triton kernel as its per-shard body
    (the GPU table's choice), on 4 virtual devices, equals one-device
    execution of the reference scan — including shard padding to whole
    tiles."""
    import jax

    from quicked_tpu.aligner import lanes
    from quicked_tpu.ops.banded_jax import run_banded
    from quicked_tpu.parallel import mesh as pm

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    monkeypatch.setattr(lanes, "score_impl", lambda table: partial(
        bt.banded_triton_impl, interpret=True))
    pairs = list(generate.generate_pairs(10, 160, error=0.1, seed=42))
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [50] * 10, full=full)
    got = pm.run_banded_sharded(b, pm.make_mesh(4))
    want = run_banded(b)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
