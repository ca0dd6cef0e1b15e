"""Data-parallel execution over a jax.sharding.Mesh.

The reference's only concurrency is OpenMP threads over independent pairs
(align_benchmark.c:232-306). Here pairs are lanes of the batched kernels,
and the lane axis is sharded over a 1-D device mesh with shard_map: each
card runs the device's score kernel (aligner/lanes.score_impl) on its lane
shard, with no communication between shards, and results gather back in
input order. Multi-host runs shard the input stream by process instead
(parallel/distributed.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from quicked_tpu.ops.batch_prep import BandedBatch
from quicked_tpu.ops.windowed_jax import WindowedBatch, windowed_scan_impl


import contextlib


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Single-process multi-chip execution of the FULL pipeline: every
    batched kernel call issued inside the context — cascade windowed
    bounds, banded score passes, Hirschberg levels, full fills — runs
    sharded over `mesh` (lane-axis data parallelism, bit-exact with
    single-device execution). Host-native shortcuts are disabled inside
    the context so the work actually exercises the mesh."""
    from quicked_tpu.aligner import batch as ab
    prev = ab.ACTIVE_MESH
    ab.ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        ab.ACTIVE_MESH = prev


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D data mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("data",))


def shard_lanes(batch: BandedBatch, multiple: int) -> BandedBatch:
    """Pad the lane axis to a multiple of `multiple` (shards x lanes per
    kernel program). The padded batch is an internal execution artifact
    (run_banded_sharded strips the pad from its outputs); its host-side
    sequence lists keep their original length."""
    B = batch.B
    rem = B % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    import dataclasses

    def pad_last(a, fill=0):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths, constant_values=fill)

    return dataclasses.replace(
        batch, B=B + pad,
        peq_lo=pad_last(batch.peq_lo), peq_hi=pad_last(batch.peq_hi),
        lm_lo=pad_last(batch.lm_lo), lm_hi=pad_last(batch.lm_hi),
        text=pad_last(batch.text), init_scores=pad_last(batch.init_scores),
        cutoff=pad_last(batch.cutoff, 65), prolog=pad_last(batch.prolog),
        nbr=pad_last(batch.nbr, 1), finish_v=pad_last(batch.finish_v),
        tfinish=pad_last(batch.tfinish),
        first0=pad_last(batch.first0, batch.EBB - 1),
        last0=pad_last(batch.last0), plen=pad_last(batch.plen, 1),
        tlen=pad_last(batch.tlen, 1))


def _lane_specs(full: bool):
    """PartitionSpecs: every array is sharded on its trailing lane axis."""
    in_specs = (
        P(None, None, "data"),  # peq_lo
        P(None, None, "data"),  # peq_hi
        P(None, "data"),        # lm_lo
        P(None, "data"),        # lm_hi
        P(None, "data"),        # text
        P(None, "data"),        # init_scores
    ) + (P("data"),) * 7        # cutoff..last0 lane vectors
    out_specs = dict(
        scores_by_k=P(None, "data"),
        pv_lo=P(None, "data"), pv_hi=P(None, "data"),
        mv_lo=P(None, "data"), mv_hi=P(None, "data"),
        first=P("data"), last=P("data"))
    if full:
        out_specs.update(
            mat_pv_lo=P(None, None, "data"), mat_pv_hi=P(None, None, "data"),
            mat_mv_lo=P(None, None, "data"), mat_mv_hi=P(None, None, "data"))
    return in_specs, out_specs


# jit-wrapper cache: a fresh shard_map/jit object per call would defeat
# the jit cache and re-trace on every invocation
_BANDED_FNS: dict = {}
_WINDOWED_FNS: dict = {}


def _shard_multiple(B: int, n: int) -> int:
    """Lane-count multiple for an n-way shard: n times the per-shard
    kernel tile, so every shard's lanes fill whole programs."""
    from quicked_tpu.ops.banded_triton import tile_lanes

    return n * tile_lanes(-(-B // n))


def run_banded_sharded(batch: BandedBatch, mesh: Mesh | None = None):
    """Execute the banded kernel with lanes sharded over the mesh.

    Returns a dict of host numpy arrays, identical to
    banded_jax.run_banded (bit-exact: lanes are independent; any lane
    padding added for divisibility is stripped from the outputs)."""
    if mesh is None:
        mesh = make_mesh()
    from quicked_tpu.aligner import lanes

    n = mesh.devices.size
    B_orig = batch.B
    batch = shard_lanes(batch, _shard_multiple(batch.B, n))
    impl = lanes.score_impl(lanes.current())
    key = (mesh, batch.EBB, batch.NB, batch.full, impl)
    fn = _BANDED_FNS.get(key)
    if fn is None:
        in_specs, out_specs = _lane_specs(batch.full)
        # check_vma=False: lanes are fully independent (no collectives);
        # scan carries initialised inside the body are unvarying by
        # construction.
        fn = jax.jit(jax.shard_map(
            partial(impl, EBB=batch.EBB, NB=batch.NB, full=batch.full),
            mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False))
        _BANDED_FNS[key] = fn
    args = (batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
            batch.text, batch.init_scores, batch.cutoff, batch.prolog,
            batch.nbr, batch.finish_v, batch.tfinish, batch.first0,
            batch.last0)
    out = fn(*[jnp.asarray(a) for a in args])
    # every output's lane axis is trailing — strip the shard padding
    return {k: np.asarray(v)[..., :B_orig] for k, v in out.items()}


_HSPLIT_FNS: dict = {}


def run_level_splits_sharded(batch: BandedBatch, mesh: Mesh | None = None):
    """One Hirschberg split level, sharded AND fused: each shard runs
    the banded score scan on its lane shard and immediately computes
    the split epilogue (hsplit_epilogue_interleaved), so only O(tasks)
    split tuples leave the devices — no per-level band-plane gather.

    `batch` must be fwd/rev INTERLEAVED (lanes [f0, r0, f1, r1, ...])
    with an even per-shard width so each task's halves co-locate.
    Returns (pll, score_l, score_r, feasible) numpy arrays per task."""
    from quicked_tpu.aligner import lanes

    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    if batch.B % n or (batch.B // n) % 2:
        raise ValueError(f"interleaved lane count {batch.B} needs an even "
                         f"width per {n}-shard")
    impl = lanes.score_impl(lanes.current())
    key = (mesh, batch.EBB, batch.NB, impl)
    fn = _HSPLIT_FNS.get(key)
    if fn is None:
        from quicked_tpu.ops.hirschberg_split_jax import (
            hsplit_epilogue_interleaved,
        )

        EBB, NB = batch.EBB, batch.NB

        def shard_fn(*args):
            plen, tlen = args[-2], args[-1]
            out = impl(*args[:-2], EBB=EBB, NB=NB, full=False)
            return hsplit_epilogue_interleaved(
                out["scores_by_k"], out["pv_lo"], out["pv_hi"],
                out["mv_lo"], out["mv_hi"], out["first"], out["last"],
                args[7], plen, tlen, EBB=EBB)

        in_specs, _ = _lane_specs(False)
        in_specs = in_specs + (P("data"), P("data"))
        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh, in_specs=in_specs,
            out_specs=(P("data"),) * 4, check_vma=False))
        _HSPLIT_FNS[key] = fn
    args = (batch.peq_lo, batch.peq_hi, batch.lm_lo, batch.lm_hi,
            batch.text, batch.init_scores, batch.cutoff, batch.prolog,
            batch.nbr, batch.finish_v, batch.tfinish, batch.first0,
            batch.last0, batch.plen.astype(np.int32),
            batch.tlen.astype(np.int32))
    out = fn(*[jnp.asarray(a) for a in args])
    return [np.asarray(v) for v in out]


def run_windowed_sharded(batch: WindowedBatch, hew_threshold: int,
                         window_size: int, overlap_size: int,
                         mesh: Mesh | None = None):
    """Execute the score-only windowed kernel with lanes sharded over the
    mesh. Returns (score, hew) numpy arrays (bit-exact vs single-chip)."""
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    if batch.B % n:
        raise ValueError(f"lane count {batch.B} not divisible by mesh "
                         f"size {n}; pad_to_b accordingly")
    from quicked_tpu.ops.windowed_jax import hew_cell_threshold

    hew_cells = np.full(batch.B,
                        hew_cell_threshold(window_size, overlap_size,
                                           hew_threshold),
                        dtype=np.int32)
    key = (mesh, window_size, overlap_size)
    fn = _WINDOWED_FNS.get(key)
    if fn is None:
        in_specs = (P(None, None, "data"), P(None, None, "data"),
                    P(None, "data"), P(None, "data"), P(None, "data"),
                    P("data"), P("data"), P("data"), P("data"))
        fn = jax.jit(jax.shard_map(
            partial(windowed_scan_impl, WS=window_size, OVL=overlap_size),
            mesh=mesh, in_specs=in_specs,
            out_specs=(P("data"), P("data")), check_vma=False))
        _WINDOWED_FNS[key] = fn
    score, hew = fn(
        jnp.asarray(batch.peq_lo), jnp.asarray(batch.peq_hi),
        jnp.asarray(batch.text_enc), jnp.asarray(batch.text_raw),
        jnp.asarray(batch.pat_raw), jnp.asarray(batch.plen),
        jnp.asarray(batch.tlen), jnp.asarray(batch.num_words),
        jnp.asarray(hew_cells))
    return np.asarray(score), np.asarray(hew)
