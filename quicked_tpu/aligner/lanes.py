"""Which kernel lanes exist on this device, and how each is chosen.

The one place that names a platform. Every routing decision in the
engine (aligner/batch.py, aligner/cascade.py, parallel/mesh.py) reads
the entry of the platform JAX runs on; a platform with no entry is an
error, never a default.

Entries:

  cpu  The host C kernels serve every batch they can: score passes,
       full fills, windowed bounds and the whole cascade in one native
       call. Without the native library, the plain XLA kernels run on
       the CPU backend.
  gpu  Shallow score batches run the Pallas-Triton kernel
       (ops/banded_triton.py); deep bands go to host C or the XLA
       carry-scan (ops/banded_cscan_jax.py) by estimated time, with
       rates measured on the card;
       full fills run on the card with the traceback walked there
       (ops/banded_traceback_jax.py) when the measured link clears the
       records' readback; Hirschberg split levels fuse the split
       epilogue after the score kernel; the cascade's short pairs take
       the native C lane.
"""

from __future__ import annotations

import dataclasses


class UnsupportedPlatform(RuntimeError):
    """JAX runs on a platform this engine has no lanes for."""


@dataclasses.dataclass(frozen=True)
class Lanes:
    platform: str
    #: the host C kernels serve every batch they can (no device lanes)
    host_first: bool
    #: shallow-band score kernel on the device: "triton" or "xla"
    score_kernel: str


# Deepest band (64-bit blocks) the pairs-as-lanes kernels take; deeper
# bands are the deep-score lane's.
SHALLOW_MAX_EBB = 128

TABLE = {
    "cpu": Lanes(platform="cpu", host_first=True, score_kernel="xla"),
    "gpu": Lanes(platform="gpu", host_first=False, score_kernel="triton"),
}


def for_platform(platform: str) -> Lanes:
    try:
        return TABLE[platform]
    except KeyError:
        raise UnsupportedPlatform(
            f"no kernel lanes for platform {platform!r}; "
            f"supported: {sorted(TABLE)}") from None


def current() -> Lanes:
    """The entry of the platform JAX's default device is on."""
    import jax

    return for_platform(jax.devices()[0].platform)


def is_deep(ebb: int) -> bool:
    """Deep bands never reach the pairs-as-lanes kernels."""
    return ebb > SHALLOW_MAX_EBB


def score_impl(lanes: Lanes):
    """The unjitted per-shard score/full body for the sharded path:
    banded_jax.banded_scan_impl's signature."""
    if lanes.score_kernel == "triton":
        from quicked_tpu.ops.banded_triton import banded_triton_impl
        return banded_triton_impl
    from quicked_tpu.ops.banded_jax import banded_scan_impl
    return banded_scan_impl
