"""quicked_tpu — a batched pairwise sequence-alignment engine in JAX.

A from-scratch reimplementation of the capabilities of QuickEd
(bound-and-align edit-distance alignment, reference: maxdoblas/QuickEd):
batched Myers bit-parallel kernels (a Pallas-Triton kernel on the GPU,
plain XLA elsewhere) beside a native C host runtime, host orchestration
in JAX, data-parallel scaling via jax.sharding.

Public surface (mirrors the reference C API, quicked/quicked.h:36-96,
re-expressed batch-first):

  - QuickedAlgo / QuickedStatus / QuickedParams  (params.py)
  - QuickedAligner        — single-pair convenience API (api.py)
  - BatchAligner          — the batch-first production API (api.py)
  - Cigar                 — alignment-path container (cigar.py)
"""

from quicked_tpu.params import (
    QuickedAlgo,
    QuickedStatus,
    QuickedParams,
    QuickedException,
    default_params,
    status_msg,
    check_error,
    QUICKED_WINDOW_STAGES,
    QUICKED_FAST_WINDOW_SIZE,
    QUICKED_FAST_WINDOW_OVERLAP,
)
from quicked_tpu.cigar import Cigar
from quicked_tpu.api import QuickedAligner, BatchAligner, align_batch

# Convenience re-exports matching the reference enum spellings
# (bindings/python/quicked.cpp:48-63).
QUICKED = QuickedAlgo.QUICKED
WINDOWED = QuickedAlgo.WINDOWED
BANDED = QuickedAlgo.BANDED
HIRSCHBERG = QuickedAlgo.HIRSCHBERG

__version__ = "0.1.0"

__all__ = [
    "QuickedAlgo",
    "QuickedStatus",
    "QuickedParams",
    "QuickedException",
    "QuickedAligner",
    "BatchAligner",
    "align_batch",
    "Cigar",
    "default_params",
    "status_msg",
    "check_error",
    "QUICKED",
    "WINDOWED",
    "BANDED",
    "HIRSCHBERG",
    "QUICKED_WINDOW_STAGES",
    "QUICKED_FAST_WINDOW_SIZE",
    "QUICKED_FAST_WINDOW_OVERLAP",
]
