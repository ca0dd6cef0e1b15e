"""Public aligner API.

`QuickedAligner` mirrors the reference object API
(quicked.h:56-67, bindings/cpp/quicked.hpp:47-69): set params, call
align(), read score/cigar. `BatchAligner`/`align_batch` are the
batch-first production surface (the unit of work is a batch of pairs;
see SURVEY.md §7).
"""

from __future__ import annotations

from quicked_tpu.cigar import Cigar
from quicked_tpu.params import (
    QuickedAlgo,
    QuickedParams,
    QuickedStatus,
    QuickedException,
    check_error,
)
from quicked_tpu.ops import myers_np


def _align_one_np(pattern: str, text: str, params: QuickedParams):
    """Single-pair alignment through the exact numpy semantic model.

    Returns (status, score, cigar_str or None).
    """
    plen, tlen = len(pattern), len(text)
    if plen == 0 or tlen == 0:
        return QuickedStatus.QUICKED_EMPTY_SEQUENCE, -1, None
    max_len = max(plen, tlen)
    algo = params.algo
    if algo == QuickedAlgo.BANDED:
        cutoff = max_len * params.bandwidth // 100
        score, ops = myers_np.banded_align(pattern, text, cutoff,
                                           only_score=params.only_score)
        status = QuickedStatus.QUICKED_WIP
    elif algo == QuickedAlgo.WINDOWED:
        score, ops, _ = myers_np.windowed_compute(
            pattern, text, 0, params.window_size, params.overlap_size,
            score_only=params.only_score)
        status = QuickedStatus.QUICKED_WIP
    elif algo == QuickedAlgo.HIRSCHBERG:
        cutoff = max_len * params.bandwidth // 100
        status, ops = myers_np.hirschberg(text, pattern, cutoff)
        score = None
    elif algo == QuickedAlgo.QUICKED:
        status, ops = myers_np.quicked_align(
            pattern, text, bandwidth=params.bandwidth,
            window_size=params.window_size, overlap_size=params.overlap_size,
            hew_threshold=params.hew_threshold,
            hew_percentage=params.hew_percentage)
        # run_quicked ignores the Hirschberg status and returns WIP
        # (quicked.c:290-305); the partial CIGAR is extracted as usual
        status = QuickedStatus.QUICKED_WIP
        score = None
    else:
        return QuickedStatus.QUICKED_UNKNOWN_ALGO, -1, None

    if check_error(status):
        # extract_results still runs on failure (quicked.c:154-157,
        # run_hirschberg): report the partial right-side CIGAR and its
        # score alongside the error status
        cigar = Cigar(operations=ops or "")
        return status, cigar.score_edit(), (cigar.sprint(True) if ops
                                            else None)
    # extract_results semantics (quicked.c:34-56): only_score keeps the
    # cigar NULL for EVERY algorithm (the score is the precomputed
    # cigar->score, == the ops' edit score when ops were computed).
    if params.only_score:
        if ops is None:
            return status, score, None
        return status, Cigar(operations=ops).score_edit(), None
    cigar = Cigar(operations=ops or "")
    return status, cigar.score_edit(), cigar.sprint(True) if ops else None


class QuickedAligner:
    """Single-pair convenience aligner (reference API parity).

    Routes through the batch engine when params.use_kernels and a
    batch engine is available; otherwise uses the exact numpy model.
    """

    def __init__(self, params: QuickedParams | None = None):
        self.params = params or QuickedParams()
        self.score: int = -1
        self.cigar: str | None = None
        self.status: QuickedStatus = QuickedStatus.QUICKED_OK

    # Setter parity with bindings/cpp/quicked.hpp:54-63.
    def set_algorithm(self, algo: QuickedAlgo):
        self.params.algo = QuickedAlgo(algo)

    def set_only_score(self, only_score: bool):
        self.params.only_score = only_score

    def set_bandwidth(self, bandwidth: int):
        self.params.bandwidth = bandwidth

    def set_window_size(self, window_size: int):
        self.params.window_size = window_size

    def set_overlap_size(self, overlap_size: int):
        self.params.overlap_size = overlap_size

    def set_force_scalar(self, force_scalar: bool):
        self.params.force_scalar = force_scalar

    def set_hew_threshold(self, hew_threshold: int):
        self.params.hew_threshold = (hew_threshold,) * 2

    def set_hew_percentage(self, hew_percentage: int):
        self.params.hew_percentage = (hew_percentage,) * 2

    # CamelCase aliases matching the pybind11 module surface
    # (bindings/python/quicked.cpp:33-45).
    setAlgorithm = set_algorithm
    setOnlyScore = set_only_score
    setBandwidth = set_bandwidth
    setWindowSize = set_window_size
    setOverlapSize = set_overlap_size
    setForceScalar = set_force_scalar
    setHEWThreshold = set_hew_threshold
    setHEWPercentage = set_hew_percentage

    def align(self, pattern: str, text: str) -> QuickedStatus:
        status, score, cigar = align_pair(pattern, text, self.params)
        # update results BEFORE raising: the reference binding runs
        # extract_results before throwing (quicked.cpp:30-42), so a
        # caller catching QuickedException reads the failed pair's
        # partial score/CIGAR, not the previous pair's
        self.status = status
        self.score = score
        self.cigar = cigar
        if check_error(status):
            raise QuickedException(status)
        return status

    def get_score(self) -> int:
        return self.score

    def get_cigar(self) -> str:
        return self.cigar if self.cigar is not None else "NULL"

    getScore = get_score
    getCigar = get_cigar


def align_pair(pattern: str, text: str, params: QuickedParams | None = None):
    """Align one pair. Returns (status, score, cigar_str|None)."""
    params = params or QuickedParams()
    if params.use_kernels:
        try:
            from quicked_tpu.aligner.batch import align_batch_full
            res = align_batch_full([(pattern, text)], params)
            return res.status[0], res.score[0], res.cigar[0]
        except ImportError:
            pass
    return _align_one_np(pattern, text, params)


class BatchAligner:
    """Batch-first aligner: the production API.

    align(pairs) -> BatchResult with per-pair status/score/cigar.
    """

    def __init__(self, params: QuickedParams | None = None):
        self.params = params or QuickedParams()

    def align(self, pairs: list[tuple[str, str]]):
        return align_batch(pairs, self.params)


def align_batch(pairs, params: QuickedParams | None = None):
    """Align a batch of (pattern, text) pairs."""
    params = params or QuickedParams()
    from quicked_tpu.aligner.batch import align_batch_full
    return align_batch_full(pairs, params)
