"""Native host runtime: ctypes bindings over libquicked_host.

The shared library is built lazily from `src/quicked_host.c` with the
system C compiler (no pip deps); consumers check `available()` and fall
back to the pure-Python implementations when the toolchain is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "quicked_host.c")
_LIB_PATH = os.path.join(_DIR, "libquicked_host.so")

_lock = threading.Lock()
_lib = None
_tried = False

# Per-thread default-thread-count override (see thread_budget): lets a
# caller running several native calls concurrently split the host cores
# between them instead of each call claiming cpu_count.
_tls = threading.local()


def default_threads() -> int:
    """Default n_threads for batched native calls: the active
    thread_budget if set, else QUICKED_TPU_CPU_THREADS, else all cores."""
    budget = getattr(_tls, "budget", None)
    if budget is not None:
        return budget
    env = os.environ.get("QUICKED_TPU_CPU_THREADS")
    if env is not None:
        return int(env)
    try:    # affinity-aware: a cgroup-pinned process must not spawn
            # machine-wide thread counts
        return max(len(os.sched_getaffinity(0)), 1)
    except (AttributeError, OSError):
        return os.cpu_count() or 1


class thread_budget:
    """Context manager bounding this thread's native-call thread use."""

    def __init__(self, n: int):
        self._n = max(int(n), 1)

    def __enter__(self):
        self._prev = getattr(_tls, "budget", None)
        _tls.budget = self._n
        return self

    def __exit__(self, *exc):
        _tls.budget = self._prev
        return False

_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64


def _build() -> bool:
    # -march=native roughly doubles the SIMD banded kernel (the GCC
    # vector extensions widen to AVX2); fall back to the portable build
    # on toolchains that reject it
    variants = (["-O3", "-march=native"], ["-O3"])
    # compile to a private temp path and publish with an atomic rename:
    # a timed-out cc or a concurrent builder in another process must
    # never leave a partial .so at the final path (CDLL would then
    # raise on every subsequent run instead of falling back)
    tmp = f"{_LIB_PATH}.build{os.getpid()}"
    for cc in ("cc", "gcc", "clang"):
        for flags in variants:
            try:
                subprocess.run(
                    [cc, *flags, "-shared", "-fPIC", "-pthread", "-o",
                     tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _LIB_PATH)
                return True
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired, OSError):
                continue
    try:
        os.remove(tmp)
    except OSError:
        pass
    return False


def _retain_large_allocations():
    """Raise glibc's mmap/trim thresholds so the batch lanes' large
    scratch buffers (packed sequences, op planes, RLE output) are
    reused from the heap instead of munmap'd on every free. First-touch
    page faults on this class of VM are erratically slow (measured
    10 ms..5 s for an 80 MB working set on a 4-core VM); retaining the
    pages makes warm batch calls deterministic. QUICKED_TPU_MALLOC_RETAIN=0
    opts out (lower RSS, variable latency)."""
    if os.environ.get("QUICKED_TPU_MALLOC_RETAIN", "1") == "0":
        return
    try:
        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):
        pass  # non-glibc: no mallopt, keep defaults


_prefaulted = False


def _ensure_prefault():
    """Pre-fault the heap once, sequentially, from this thread:
    demand-faulting the same pages later in random order from the
    concurrent batch workers is ~20x slower per page (mmap_lock
    contention) and was the dominant cost of a cold large batch call
    (2.7 s -> 0.36 s measured). Called lazily before the first large
    batch so tiny calls never pay the ~80 ms."""
    global _prefaulted
    if _prefaulted:
        return
    _prefaulted = True
    if os.environ.get("QUICKED_TPU_MALLOC_RETAIN", "1") == "0":
        return
    try:
        libc = ctypes.CDLL(None)
        mb = int(os.environ.get("QUICKED_TPU_MALLOC_PREFAULT_MB", 128))
        if mb > 0:
            libc.malloc.restype = ctypes.c_void_p
            p = libc.malloc(mb << 20)
            if p:
                ctypes.memset(p, 0, mb << 20)
                libc.free(ctypes.c_void_p(p))
    except (OSError, AttributeError):
        pass


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        _retain_large_allocations()
        if not os.path.exists(_LIB_PATH) or \
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            if not _build():
                print("quicked_tpu: native host lib unavailable "
                      "(no C compiler); using Python fallbacks",
                      file=sys.stderr)
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # corrupt leftover (e.g. from an older non-atomic build):
            # rebuild once, then give up to the Python fallbacks
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
        lib.qh_encode_dna.argtypes = [_u8p, _i64, _u8p]
        lib.qh_traceback_banded.restype = _i64
        lib.qh_traceback_banded.argtypes = [
            _u32p, _u32p, _u32p, _u32p, _i64, _i64, _i64,
            _u8p, _i64, _u8p, _i64, _i64, ctypes.c_char_p]
        lib.qh_cigar_score_edit.restype = _i64
        lib.qh_cigar_score_edit.argtypes = [ctypes.c_char_p, _i64]
        lib.qh_cigar_check.restype = ctypes.c_int
        lib.qh_cigar_check.argtypes = [ctypes.c_char_p, _i64, _u8p, _i64,
                                       _u8p, _i64]
        lib.qh_cigar_sprint.restype = _i64
        lib.qh_cigar_sprint.argtypes = [ctypes.c_char_p, _i64,
                                        ctypes.c_int, ctypes.c_char_p]
        lib.qh_cigar_sam.restype = _i64
        lib.qh_cigar_sam.argtypes = [ctypes.c_char_p, _i64, _u32p]
        _i64p = ctypes.POINTER(ctypes.c_int64)
        lib.qh_read_seq_batch.restype = _i64
        # first arg is c_void_p (not c_char_p) so callers can pass a
        # base+offset address into a bytes buffer without slicing it
        lib.qh_read_seq_batch.argtypes = [
            ctypes.c_void_p, _i64, _i64, ctypes.c_char_p, _i64,
            _i64p, _i64p, _i64p]
        _u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.qh_banded_score.restype = _i64
        lib.qh_banded_score.argtypes = [
            _u8p, _i64, _u8p, _i64, _i64, _i64,
            _u64p, _u64p, _i64p, _i64p, _i64p, _i64p]
        lib.qh_banded_score_mt.restype = _i64
        lib.qh_banded_score_mt.argtypes = [
            _u8p, _i64, _u8p, _i64, _i64, _i64,
            _u64p, _u64p, _i64p, _i64p, _i64p, _i64p, _i64]
        lib.qh_banded_align_full.restype = _i64
        lib.qh_banded_align_full.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64,
            ctypes.c_char_p, _i64p]
        lib.qh_windowed_score.restype = _i64
        lib.qh_windowed_score.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64, _i64, _i64p]
        lib.qh_windowed_full.restype = _i64
        lib.qh_windowed_full.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64,
            ctypes.c_char_p]
        lib.qh_quicked_batch.restype = _i64
        lib.qh_quicked_batch.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _i64p, _i64p, ctypes.c_char_p, _i64p, _i64p]
        lib.qh_cigar_sprint_batch.restype = _i64
        lib.qh_cigar_sprint_batch.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64, _i64,
            ctypes.c_char_p, _i64p, _i64p, _i64]
        _u64p2 = ctypes.POINTER(ctypes.c_uint64)
        lib.qh_banded_score_batch.restype = _i64
        lib.qh_banded_score_batch.argtypes = [
            _u8p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
            _i64, _i64, _i64, _i64p,
            _u64p2, _u64p2, _i64, _i64p, _i64p, _i64p, _i64, _i64p]
        lib.qh_hirschberg.restype = _i64
        lib.qh_hirschberg.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64,
            ctypes.c_char_p, _i64p]
        lib.qh_align.restype = _i64
        lib.qh_align.argtypes = [
            _i64, _u8p, _i64, _u8p, _i64,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _i64p, ctypes.c_char_p, _i64p]
        lib.qh_traceback_banded_batch.restype = _i64
        lib.qh_traceback_banded_batch.argtypes = [
            _u32p, _u32p, _u32p, _u32p, _i64, _i64, _i64,
            _u8p, _i64p, _i64p, _u8p, _i64p, _i64p,
            _i64p, _i64, ctypes.c_char_p, _i64p, _i64p, _i64]
        _u16p = ctypes.POINTER(ctypes.c_uint16)
        _i8p = ctypes.POINTER(ctypes.c_int8)
        _i32p = ctypes.POINTER(ctypes.c_int32)
        lib.qh_expand_colruns_batch.restype = _i64
        lib.qh_expand_colruns_batch.argtypes = [
            _u16p, _i8p, _i32p, _i32p, _i64, _i64,
            ctypes.c_char_p, _i64p, _i64p]
        lib.qh_set_force_scalar.restype = None
        lib.qh_set_force_scalar.argtypes = [ctypes.c_int]
        lib.qh_get_force_scalar.restype = ctypes.c_int
        lib.qh_get_force_scalar.argtypes = []
        lib.qh_simd_pass_count.restype = _i64
        lib.qh_simd_pass_count.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def expand_colruns(runs_bt: np.ndarray, opcs_bt: np.ndarray,
                   v_fin: np.ndarray, h_fin: np.ndarray):
    """Expand (n, T) device-traceback records into one packed op-byte
    buffer + per-lane (offset, length) — the C consumer of the
    on-device banded traceback's (d_run, op) records (numpy fallback:
    ops/banded_traceback_jax.records_to_packed). Returns
    (flat uint8, offs int64, lens int64) or None when the native lib
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    runs_bt = np.ascontiguousarray(runs_bt, dtype=np.uint16)
    opcs_bt = np.ascontiguousarray(opcs_bt, dtype=np.int8)
    v_fin = np.ascontiguousarray(v_fin, dtype=np.int32)
    h_fin = np.ascontiguousarray(h_fin, dtype=np.int32)
    n, T = runs_bt.shape
    offs = np.empty(n, dtype=np.int64)
    lens = np.empty(n, dtype=np.int64)
    _u16 = ctypes.POINTER(ctypes.c_uint16)
    _i8 = ctypes.POINTER(ctypes.c_int8)
    _i32 = ctypes.POINTER(ctypes.c_int32)
    args = (runs_bt.ctypes.data_as(_u16), opcs_bt.ctypes.data_as(_i8),
            v_fin.ctypes.data_as(_i32), h_fin.ctypes.data_as(_i32),
            n, T)
    total = lib.qh_expand_colruns_batch(
        *args, None, offs.ctypes.data_as(_i64p_()),
        lens.ctypes.data_as(_i64p_()))
    flat = np.empty(int(total), dtype=np.uint8)
    lib.qh_expand_colruns_batch(
        *args, flat.ctypes.data_as(ctypes.c_char_p),
        offs.ctypes.data_as(_i64p_()), lens.ctypes.data_as(_i64p_()))
    return flat, offs, lens


def _i64p_():
    return ctypes.POINTER(ctypes.c_int64)


def set_force_scalar(v: bool) -> None:
    """Runtime SIMD toggle for the banded C kernels (the reference's
    force_scalar, bpm_banded.c:1049-1059): scalar column loop instead
    of the 4-column vector pipeline / threaded wavefront. Process-wide;
    a no-op when the native lib is unavailable (the Python/XLA
    fallbacks have no SIMD split to force)."""
    lib = _load()
    if lib is not None:
        lib.qh_set_force_scalar(1 if v else 0)


def get_force_scalar() -> bool:
    lib = _load()
    return bool(lib.qh_get_force_scalar()) if lib is not None else False


def simd_pass_count() -> int:
    """Vector 4-column passes executed so far in this process — the
    observable that proves force_scalar switched the kernel path."""
    lib = _load()
    return int(lib.qh_simd_pass_count()) if lib is not None else 0


def _u32arr(a: np.ndarray):
    assert a.dtype == np.uint32 and a.flags.c_contiguous
    return a.ctypes.data_as(_u32p)


def _u8bytes(s: bytes):
    return ctypes.cast(ctypes.c_char_p(s), _u8p)


def traceback_banded(mat_pv_lo, mat_pv_hi, mat_mv_lo, mat_mv_hi,
                     lane: int, pattern_raw: bytes, text_raw: bytes,
                     prolog: int) -> str:
    """Traceback one lane of the batched (T, EBB, B) band planes."""
    lib = _load()
    T, ebb, nlanes = mat_pv_lo.shape
    plen, tlen = len(pattern_raw), len(text_raw)
    out = ctypes.create_string_buffer(plen + tlen + 1)
    n = lib.qh_traceback_banded(
        _u32arr(mat_pv_lo), _u32arr(mat_pv_hi),
        _u32arr(mat_mv_lo), _u32arr(mat_mv_hi),
        ebb, nlanes, lane,
        _u8bytes(pattern_raw), plen, _u8bytes(text_raw), tlen,
        prolog, out)
    return out.raw[:n].decode("ascii")


def traceback_banded_batch(mats_tiled, lanes: int, praws: list,
                           traws: list, prologs) -> list:
    """Traceback EVERY pair of a lane-tiled plane set in one native
    call (pthread pool inside): pair i walks tile i//lanes, lane
    i%lanes. praws/traws are per-pair raw byte strings; returns op
    strings in order. ~60 us/pair of ctypes marshalling under the GIL
    made the per-pair entry the device full-fill lane's bottleneck."""
    lib = _load()
    pv_lo, pv_hi, mv_lo, mv_hi = mats_tiled
    P, T, ebb, nlanes = pv_lo.shape
    assert nlanes == lanes
    # dna-text semantics like _seqs_as_bytes: non-ASCII buckets to the
    # replacement byte ('?' -> N) instead of raising — the same input
    # must not succeed or crash depending on lane routing
    praws = [p.encode("ascii", "replace") if isinstance(p, str) else p
             for p in praws]
    traws = [t.encode("ascii", "replace") if isinstance(t, str) else t
             for t in traws]
    n = len(praws)
    pat_len = np.fromiter((len(p) for p in praws), np.int64, n)
    txt_len = np.fromiter((len(t) for t in traws), np.int64, n)
    pat_off = np.zeros(n, np.int64)
    np.cumsum(pat_len[:-1], out=pat_off[1:])
    txt_off = np.zeros(n, np.int64)
    np.cumsum(txt_len[:-1], out=txt_off[1:])
    caps = pat_len + txt_len
    ops_off = np.zeros(n, np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    pat_blob = b"".join(praws)
    txt_blob = b"".join(traws)
    ops_blob = ctypes.create_string_buffer(int(caps.sum()) + 1)
    ops_len = np.zeros(n, np.int64)
    prolog_arr = np.asarray(prologs, dtype=np.int64)

    def i64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    _ensure_prefault()
    planes = [np.ascontiguousarray(a).reshape(P * T, ebb, nlanes)
              for a in (pv_lo, pv_hi, mv_lo, mv_hi)]
    rc = lib.qh_traceback_banded_batch(
        _u32arr(planes[0][0]), _u32arr(planes[1][0]),
        _u32arr(planes[2][0]), _u32arr(planes[3][0]),
        T * ebb * nlanes, ebb, nlanes,
        _u8bytes(pat_blob), i64p(pat_off), i64p(pat_len),
        _u8bytes(txt_blob), i64p(txt_off), i64p(txt_len),
        i64p(prolog_arr), n,
        ops_blob, i64p(ops_off), i64p(ops_len),
        default_threads())
    assert rc == 0, rc
    raw = ops_blob.raw
    return [raw[int(ops_off[i]):int(ops_off[i]) + int(ops_len[i])]
            .decode("ascii") for i in range(n)]


def cigar_score_edit(ops: str) -> int:
    lib = _load()
    b = ops.encode("ascii")
    return int(lib.qh_cigar_score_edit(b, len(b)))


def cigar_check(ops: str, pattern: bytes, text: bytes) -> bool:
    lib = _load()
    b = ops.encode("ascii")
    return bool(lib.qh_cigar_check(b, len(b), _u8bytes(pattern),
                                   len(pattern), _u8bytes(text), len(text)))


def cigar_sprint(ops: str, print_matches: bool) -> str:
    lib = _load()
    b = ops.encode("ascii")
    out = ctypes.create_string_buffer(12 * max(len(b), 1))
    n = lib.qh_cigar_sprint(b, len(b), int(print_matches), out)
    return out.raw[:n].decode("ascii")


def cigar_sam(ops: str) -> np.ndarray:
    lib = _load()
    b = ops.encode("ascii")
    out = np.empty(max(len(b), 1), dtype=np.uint32)
    n = lib.qh_cigar_sam(b, len(b), _u32arr(out))
    return out[:n].copy()


def banded_score(pattern_enc: np.ndarray, text_enc: np.ndarray,
                 cutoff_score: int, text_len: int, text_finish: int,
                 want_state: bool = False, n_threads: int = 1):
    """Host-native BandEd score-only (CPU compute path). Returns the
    score, or with want_state a dict mirroring the device kernels'
    output for one lane (pv/mv u64 band words, first/last, scores by
    shifted row). n_threads > 1 engages the bit-exact threaded
    wavefront (row strips) inside the single pair's band."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    if not want_state:
        return int(lib.qh_banded_score_mt(
            p.ctypes.data_as(_u8p), len(p), t.ctypes.data_as(_u8p),
            text_finish, text_len, cutoff_score,
            None, None, None, None, None, None, int(n_threads)))
    # conservative capacities (see qh_banded_score)
    k_end = abs(text_len - len(p)) + 1
    cutoff = max(k_end, cutoff_score, 65)
    ebb_cap = cutoff // 64 + 2
    diff = len(p) - text_len
    rel = -(-(cutoff - abs(diff)) // 2)
    prolog = -(-rel // 64) if diff >= 0 else -(-(rel - diff) // 64)
    nb_total = max(-(-text_finish // 64), 1)
    n_rows = prolog + nb_total + ebb_cap + 2
    # the C kernel extends its rows to cover the pattern's final block
    # (init-valued) when text_finish << plen; size the buffer to match
    plen = len(p)
    fb = plen // 64 if plen % 64 else max(plen - 1, 0) // 64
    n_rows = max(n_rows, fb + prolog + 1)
    pv = np.empty(ebb_cap, dtype=np.uint64)
    mv = np.empty(ebb_cap, dtype=np.uint64)
    # Pre-fill with the C kernel's own init formula (r - prolog + 1)*64:
    # ebb_cap can exceed the kernel's exact row count by one (cutoff a
    # multiple of 64), and an np.empty tail row would otherwise leak
    # uninitialised values into scores_by_k.
    scores = ((np.arange(n_rows, dtype=np.int64) - prolog + 1) * 64)
    first = ctypes.c_int64()
    last = ctypes.c_int64()
    ebb = ctypes.c_int64()
    score = int(lib.qh_banded_score_mt(
        p.ctypes.data_as(_u8p), len(p), t.ctypes.data_as(_u8p),
        text_finish, text_len, cutoff_score,
        pv.ctypes.data_as(u64p), mv.ctypes.data_as(u64p),
        ctypes.byref(first), ctypes.byref(last),
        scores.ctypes.data_as(i64p), ctypes.byref(ebb), int(n_threads)))
    return dict(score=score, pv=pv[:ebb.value], mv=mv[:ebb.value],
                first=int(first.value), last=int(last.value),
                scores=scores, prolog=prolog, ebb=int(ebb.value))


def banded_score_batch(enc_patterns, enc_texts, cutoffs, tfinishes,
                       want_state: bool = False,
                       n_threads: int | None = None):
    """Batched score-only BandEd through ONE native call (pthread pool
    inside). Returns scores int64 (n,), or with want_state a dict of
    strided per-lane state arrays:
      pv/mv (n, ebb_stride) u64, first/last/ebb (n,),
      scores (n, rows_stride) indexed by row + prolog_i.
    """
    lib = _load()
    n = len(enc_patterns)
    if n_threads is None:
        n_threads = default_threads()
    enc_list = [np.ascontiguousarray(e, dtype=np.uint8)
                for pair in zip(enc_patterns, enc_texts) for e in pair]
    lens = np.fromiter(map(len, enc_list), np.int64, 2 * n)
    if int(lens.sum()) > 1 << 18:
        _ensure_prefault()
    offs = np.zeros(2 * n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    buf = b"".join(e.tobytes() for e in enc_list)
    p_off = np.ascontiguousarray(offs[0::2])
    t_off = np.ascontiguousarray(offs[1::2])
    p_len = np.ascontiguousarray(lens[0::2])
    t_len = np.ascontiguousarray(lens[1::2])
    cutoff = np.asarray(cutoffs, dtype=np.int64)
    tfin = np.asarray(tfinishes, dtype=np.int64)
    scores = np.zeros(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    def arr(a):
        return a.ctypes.data_as(i64p)

    if not want_state:
        lib.qh_banded_score_batch(
            _u8bytes(buf), arr(p_off), arr(p_len), arr(t_off), arr(t_len),
            arr(cutoff), arr(tfin), n, n_threads, 0, arr(scores),
            None, None, 0, None, None, None, 0, None)
        return scores
    # strided state buffers sized like the per-pair wrapper (banded_score)
    k_end = np.abs(t_len - p_len) + 1
    eff = np.maximum(np.maximum(k_end, cutoff), 65)
    ebb_cap = int((eff // 64 + 2).max())
    diff = p_len - t_len
    rel = -(-(eff - np.abs(diff)) // 2)
    prolog = np.where(diff >= 0, -(-rel // 64), -(-(rel - diff) // 64))
    nb_total = np.maximum(-(-tfin // 64), 1)
    fb = np.where(p_len % 64 != 0, p_len // 64,
                  np.maximum(p_len - 1, 0) // 64)
    n_rows = np.maximum(prolog + nb_total + ebb_cap + 2,
                        fb + prolog + 1)
    rows_stride = int(n_rows.max())
    pv = np.empty((n, ebb_cap), dtype=np.uint64)
    mv = np.empty((n, ebb_cap), dtype=np.uint64)
    first = np.zeros(n, dtype=np.int64)
    last = np.zeros(n, dtype=np.int64)
    sc_rows = np.empty((n, rows_stride), dtype=np.int64)
    # pre-fill with the init formula so rows beyond a pair's own n_rows
    # hold the deterministic defaults (the C kernel writes its exact
    # row count per pair)
    sc_rows[:] = ((np.arange(rows_stride, dtype=np.int64)[None, :]
                   - prolog[:, None] + 1) * 64)
    ebb = np.zeros(n, dtype=np.int64)
    lib.qh_banded_score_batch(
        _u8bytes(buf), arr(p_off), arr(p_len), arr(t_off), arr(t_len),
        arr(cutoff), arr(tfin), n, n_threads, 1, arr(scores),
        pv.ctypes.data_as(u64p), mv.ctypes.data_as(u64p), ebb_cap,
        arr(first), arr(last), arr(sc_rows), rows_stride, arr(ebb))
    return dict(score=scores, pv=pv, mv=mv, first=first, last=last,
                scores=sc_rows, prolog=prolog.astype(np.int64), ebb=ebb)


def banded_align_full(pattern_enc: np.ndarray, pattern_raw: bytes,
                      text_enc: np.ndarray, text_raw: bytes,
                      cutoff_score: int):
    """Host-native BandEd full alignment (fill + traceback).
    Returns (score, ops_str)."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    score = ctypes.c_int64()
    n = lib.qh_banded_align_full(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        cutoff_score, ops, ctypes.byref(score))
    if n < 0:
        raise MemoryError("qh_banded_align_full: allocation failed")
    return int(score.value), ops.raw[:n].decode("ascii")


def windowed_score(pattern_enc: np.ndarray, pattern_raw: bytes,
                   text_enc: np.ndarray, text_raw: bytes,
                   window_size: int, overlap_size: int,
                   hew_threshold: int):
    """Host-native WindowEd score bound. Returns (score, hew)."""
    if window_size > 16:
        raise ValueError(
            f"native windowed kernel supports window_size <= 16 "
            f"(got {window_size}); use the device/python path")
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    hew = ctypes.c_int64()
    score = int(lib.qh_windowed_score(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        window_size, overlap_size, hew_threshold, ctypes.byref(hew)))
    return score, int(hew.value)


def windowed_full(pattern_enc: np.ndarray, pattern_raw: bytes,
                  text_enc: np.ndarray, text_raw: bytes,
                  window_size: int, overlap_size: int) -> str:
    """Host-native WindowEd full-CIGAR mode. Returns the op string."""
    if window_size > 16:
        raise ValueError(
            f"native windowed kernel supports window_size <= 16 "
            f"(got {window_size}); use the device/python path")
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    n = lib.qh_windowed_full(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        window_size, overlap_size, ops)
    return ops.raw[:n].decode("ascii")


class LazyOpsList:
    """Per-pair op/RLE strings decoded lazily from the packed C output
    buffers. Building N Python str objects for a 100k-pair batch costs
    more than the C alignment itself for short reads; callers that
    never index the ops (benchmark rows, score-only consumers) skip the
    cost entirely. Materializes ALL elements on first access (one list
    comprehension beats 100k per-element __getitem__ calls) and then
    behaves as a plain list. Element semantics match the eager list:
    str for status==0 ("" when the op string is empty), None otherwise.
    """

    __slots__ = ("_segs", "_list", "_n", "_empty_as_none")

    def __init__(self, segs, empty_as_none=False):
        # segs: list of (ops_arr uint8, off int64[], ln int64[], status)
        self._segs = segs
        self._n = sum(len(s[3]) for s in segs)
        self._list = None
        self._empty_as_none = empty_as_none

    def _materialize(self):
        if self._list is None:
            none_val = None
            out = []
            for arr, off, ln, status in self._segs:
                raw = arr.tobytes()
                if self._empty_as_none:
                    out.extend(
                        (raw[o:o + l].decode("ascii") if l else none_val)
                        if s == 0 else none_val
                        for o, l, s in zip(off.tolist(), ln.tolist(),
                                           status.tolist()))
                else:
                    out.extend(
                        raw[o:o + l].decode("ascii") if s == 0 else none_val
                        for o, l, s in zip(off.tolist(), ln.tolist(),
                                           status.tolist()))
            self._list = out
            self._segs = None
        return self._list

    def with_empty_as_none(self):
        """View with the cascade's `x if x else None` normalization."""
        if self._list is not None:
            return [x if x else None for x in self._list]
        return LazyOpsList(self._segs, empty_as_none=True)

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, LazyOpsList):
            other = other._materialize()
        return self._materialize() == other

    def __repr__(self):
        return (f"LazyOpsList(n={self._n}, "
                f"materialized={self._list is not None})")


def _seqs_as_bytes(seqs):
    """Encode a batch of sequences (str | bytes | uint8 arrays) to a
    list of bytes with dna-text semantics (non-ASCII -> replacement,
    which the encode table buckets as 'N'). One comprehension for the
    homogeneous common cases; per-element fallback for mixed input."""
    if not seqs:
        return []
    first = seqs[0]
    try:
        if isinstance(first, str):
            return [s.encode("ascii", "replace") for s in seqs]
        if isinstance(first, (bytes, bytearray)):
            return [bytes(s) for s in seqs]
    except (AttributeError, TypeError):
        pass  # mixed types: slow path below
    return [s.encode("ascii", "replace") if isinstance(s, str)
            else bytes(s) if isinstance(s, (bytes, bytearray))
            else np.asarray(s, dtype=np.uint8).tobytes() for s in seqs]


def quicked_batch(patterns, texts, *, bandwidth: int, window_size: int,
                  overlap_size: int, hew_threshold, hew_percentage,
                  budget: int, n_threads: int | None = None,
                  rle: bool = False):
    """Full QuickEd cascade over a batch in ONE native call (pthread
    pool inside, zero per-pair Python overhead) — the host fast lane for
    short pairs and CPU-only platforms.

    Returns (status int64 array, scores int64 array, ops LazyOpsList).
    status 0: fully aligned in C (ops = op string, score = edit score);
    status 1: band footprint exceeded the Hirschberg budget — score
    holds the proven bound for the batched Hirschberg driver.
    """
    lib = _load()
    n = len(patterns)
    if n_threads is None:
        n_threads = default_threads()

    # ONE GIL-held marshal for the whole batch: lengths come from the
    # inputs directly (ascii-replace is one byte per char), the packed
    # buffer is a single interleaved join + one encode, and chunks
    # index it by ABSOLUTE offsets. The per-string encodes + per-chunk
    # list slicing + re-joins this replaces were the non-scaling term
    # of the short-read lane (measured ~95 ms GIL-held of the 0.205 s
    # 100k-pair batch at 4 threads — threads can't help Python code).
    lengths = np.empty(2 * n, dtype=np.int64)
    lengths[0::2] = np.fromiter(map(len, patterns), np.int64, n)
    lengths[1::2] = np.fromiter(map(len, texts), np.int64, n)
    offsets = np.zeros(2 * n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])

    # Chunk large batches so the scratch working set (op planes, RLE
    # output ~6x the bases) stays small and is REUSED across chunks
    # from the retained heap (_retain_large_allocations): first-touch
    # page faults on fresh pages are erratically slow on VM hosts, and
    # one-shot scratch for a 1M-pair stream would be ~GB.
    chunk_bases = int(os.environ.get("QUICKED_TPU_BATCH_CHUNK_BASES",
                                     8 << 20))
    total_bases = int(lengths.sum())
    if total_bases > 1 << 18:
        _ensure_prefault()
    if n > 1 and total_bases > 2 * chunk_bases:
        # Pipelined chunks: chunk k's GIL-held marshal (join + encode,
        # ~25 ms/10 MB) runs on this thread WHILE chunk k-1's C call
        # aligns on a worker — qh_quicked_batch releases the GIL, so
        # the only serial Python left is the first chunk's marshal.
        from concurrent.futures import ThreadPoolExecutor

        status = np.zeros(n, dtype=np.int64)
        scores = np.zeros(n, dtype=np.int64)
        pair_bases = lengths[0::2] + lengths[1::2]
        ranges = []
        lo = 0
        while lo < n:
            hi, acc = lo, 0
            while hi < n and (hi == lo or acc < chunk_bases):
                acc += int(pair_bases[hi])
                hi += 1
            ranges.append((lo, hi))
            lo = hi
        segs: list = [None] * len(ranges)

        def collect(k, fut):
            c_st, c_sc, c_seg = fut.result()
            l0, h0 = ranges[k]
            status[l0:h0] = c_st
            scores[l0:h0] = c_sc
            segs[k] = c_seg

        with ThreadPoolExecutor(1) as ex:
            fut, fut_k = None, -1
            for k, (lo, hi) in enumerate(ranges):
                cbuf = _pack_pairs_interleaved(patterns[lo:hi],
                                               texts[lo:hi])
                coffs = offsets[2 * lo:2 * hi] - offsets[2 * lo]
                if fut is not None:
                    collect(fut_k, fut)
                fut = ex.submit(
                    _quicked_batch_run, lib, cbuf, coffs,
                    lengths[2 * lo:2 * hi],
                    bandwidth=bandwidth, window_size=window_size,
                    overlap_size=overlap_size,
                    hew_threshold=hew_threshold,
                    hew_percentage=hew_percentage, budget=budget,
                    n_threads=n_threads, rle=rle)
                fut_k = k
            collect(fut_k, fut)
        return status, scores, LazyOpsList(segs)
    buf = _pack_pairs_interleaved(patterns, texts)
    st, sc, seg = _quicked_batch_run(
        lib, buf, offsets, lengths, bandwidth=bandwidth,
        window_size=window_size, overlap_size=overlap_size,
        hew_threshold=hew_threshold, hew_percentage=hew_percentage,
        budget=budget, n_threads=n_threads, rle=rle)
    return st, sc, LazyOpsList([seg])


def _pack_pairs_interleaved(patterns, texts) -> bytes:
    """Pack pattern/text pairs interleaved into ONE bytes buffer with
    dna-text semantics (non-ASCII -> replacement, 1 byte per char).
    All-str batches take a single join + one encode — ~2x faster than
    200k per-string encodes at workload-3 scale."""
    from itertools import chain

    if patterns and isinstance(patterns[0], str):
        try:
            return "".join(chain.from_iterable(zip(patterns, texts))) \
                .encode("ascii", "replace")
        except TypeError:
            pass            # mixed input kinds: per-element fallback
    pb = _seqs_as_bytes(patterns)
    tb = _seqs_as_bytes(texts)
    return b"".join(b for pair in zip(pb, tb) for b in pair)


def _quicked_batch_run(lib, buf, offsets, lengths, *, bandwidth,
                       window_size, overlap_size, hew_threshold,
                       hew_percentage, budget, n_threads, rle):
    """One native cascade call over a chunk: `offsets`/`lengths` are
    contiguous (2*n,) views with offsets ABSOLUTE into `buf`."""
    n = len(lengths) // 2
    pair_caps = lengths[0::2] + lengths[1::2]
    ops_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(pair_caps[:-1], out=ops_off[1:])
    total_cap = int(pair_caps.sum())
    ops_arr = np.empty(max(total_cap, 1), dtype=np.uint8)
    ops_buf = ops_arr.ctypes.data_as(ctypes.c_char_p)
    scores = np.zeros(n, dtype=np.int64)
    status = np.zeros(n, dtype=np.int64)
    ops_len = np.zeros(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def arr(a):
        return a.ctypes.data_as(i64p)

    lib.qh_quicked_batch(
        buf, arr(offsets), arr(lengths), n,
        bandwidth, window_size, overlap_size,
        hew_threshold[0], hew_threshold[1],
        hew_percentage[0], hew_percentage[1],
        budget, n_threads,
        arr(scores), arr(status), ops_buf, arr(ops_off), arr(ops_len))
    if rle:
        # one more C pass: RLE-print every CIGAR into a second buffer
        out_caps = 3 * pair_caps + 16
        out_off = np.zeros(n, dtype=np.int64)
        if n > 1:
            np.cumsum(out_caps[:-1], out=out_off[1:])
        out_arr = np.empty(max(int(out_caps.sum()), 1), dtype=np.uint8)
        out_len = np.zeros(n, dtype=np.int64)
        lib.qh_cigar_sprint_batch(
            ops_buf, arr(ops_off), arr(ops_len), n, 1,
            out_arr.ctypes.data_as(ctypes.c_char_p), arr(out_off),
            arr(out_len), n_threads)
        return status, scores, (out_arr, out_off, out_len, status)
    return status, scores, (ops_arr, ops_off, ops_len, status)


def hirschberg(pattern_enc: np.ndarray, pattern_raw: bytes,
               text_enc: np.ndarray, text_raw: bytes,
               cutoff_score: int, budget: int):
    """Host-native Hirschberg full alignment. Returns (status, ops_str):
    status 0 ok, -2 non-convergence (ops = the partial right side)."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    n = ctypes.c_int64()
    st = int(lib.qh_hirschberg(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        cutoff_score, budget, ops, ctypes.byref(n)))
    return st, ops.raw[:n.value].decode("ascii")


def align_one(algo: int, pattern_raw: bytes, text_raw: bytes, *,
              only_score: bool = False, bandwidth: int = 15,
              window_size: int = 9, overlap_size: int = 1,
              hew_threshold=(40, 40), hew_percentage=(15, 15),
              budget: int = 16 * 1024 * 1024):
    """Single-pair quicked_align through the native runtime (qh_align).
    Returns (status, score, ops_str|None)."""
    lib = _load()
    ops = ctypes.create_string_buffer(len(pattern_raw) + len(text_raw) + 1)
    score = ctypes.c_int64()
    n = ctypes.c_int64()
    st = int(lib.qh_align(
        algo, _u8bytes(pattern_raw), len(pattern_raw),
        _u8bytes(text_raw), len(text_raw),
        int(only_score), bandwidth, window_size, overlap_size,
        hew_threshold[0], hew_threshold[1],
        hew_percentage[0], hew_percentage[1], budget,
        ctypes.byref(score), ops, ctypes.byref(n)))
    op_str = ops.raw[:n.value].decode("ascii") if n.value > 0 else None
    return st, int(score.value), op_str


def read_seq_batch(data: bytes, max_pairs: int, offset: int = 0):
    """Parse up to max_pairs 2-line .seq records from `data[offset:]`.
    Returns (pairs list of (pattern, text) str, consumed bytes).

    offset avoids the caller slicing `data[pos:]` per call — on
    multi-MB stream chunks that slice (plus a full out-buffer copy this
    function used to make) amplified parse traffic ~20x (measured: the
    10M-pair workload spent more time copying than parsing)."""
    lib = _load()
    remaining = len(data) - offset
    offsets = np.empty(2 * max_pairs, dtype=np.int64)
    lengths = np.empty(2 * max_pairs, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
    # modest out buffer first (the parser stops cleanly when full,
    # quicked_host.c:1144); retry at full size only if a single record
    # exceeds it
    cap = min(remaining, 4 << 20) + 2
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.qh_read_seq_batch(
            ctypes.c_void_p(base + offset), remaining, max_pairs,
            out, cap,
            offsets.ctypes.data_as(i64p), lengths.ctypes.data_as(i64p),
            ctypes.byref(consumed))
        if n > 0 or consumed.value > 0 or cap >= remaining + 2:
            break
        cap = remaining + 2
    pairs = []
    for i in range(n):
        po, pl = int(offsets[2 * i]), int(lengths[2 * i])
        to, tl = int(offsets[2 * i + 1]), int(lengths[2 * i + 1])
        pairs.append((out[po:po + pl].decode("ascii"),
                      out[to:to + tl].decode("ascii")))
    return pairs, int(consumed.value)


def encode_dna(raw: bytes) -> np.ndarray:
    lib = _load()
    out = np.empty(len(raw), dtype=np.uint8)
    lib.qh_encode_dna(_u8bytes(raw), len(raw),
                      out.ctypes.data_as(_u8p))
    return out
