"""Multi-host data-parallel alignment driver.

The reference's only scale-out is OpenMP threads over pairs
(align_benchmark.c:232-306). Here the same independence is exploited
across processes/hosts: each JAX process takes a strided shard of the
input stream, aligns it locally through the batch engine (its local
devices form the local mesh), writes an indexed shard file, and the
coordinator merges shards into the input-ordered output — the ordered
result merge of BASELINE.md's north star.

Launch: one process per host with the standard JAX distributed
environment (jax.distributed.initialize args or
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), all
writing to a shared filesystem. Where several processes share a host,
give each its own card with JAX_LOCAL_DEVICE_IDS (e.g. "0" for the
first, "1" for the second): a JAX process otherwise reserves three
quarters of every card it sees. Degenerates to a plain single-process
run when no distributed environment is configured.
"""

from __future__ import annotations

import glob
import os

from quicked_tpu import seqio
from quicked_tpu.params import QuickedParams


def maybe_initialize_distributed() -> tuple[int, int]:
    """Initialize jax.distributed when configured; returns
    (process_index, process_count)."""
    import jax

    already = False
    try:
        from jax._src.distributed import global_state
        already = global_state.client is not None
    except (ImportError, AttributeError):  # private module moved or
        pass                  # attribute renamed: fall through to
                              # initialize() and its error filter
    if not already and os.environ.get("JAX_COORDINATOR_ADDRESS") and \
            os.environ.get("JAX_NUM_PROCESSES"):
        try:
            # Pass the triplet explicitly: jax's cluster auto-detection
            # recognizes scheduler environments (SLURM, MPI, k8s), not
            # these generic variable names the launch docs promise.
            pid = os.environ.get("JAX_PROCESS_ID")
            local = os.environ.get("JAX_LOCAL_DEVICE_IDS")
            jax.distributed.initialize(
                coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=int(pid) if pid is not None else None,
                local_device_ids=([int(x) for x in local.split(",")]
                                  if local else None))
        except RuntimeError as e:
            # Only an already-initialized runtime is benign; swallowing
            # e.g. an unreachable coordinator would silently degrade
            # every process to a full single-process run over the same
            # shard file.
            if "already initialized" not in str(e).lower():
                raise
    return jax.process_index(), jax.process_count()


def distributed_align(input_path: str, output_path: str,
                      params: QuickedParams | None = None,
                      batch_size: int = 10000,
                      process_index: int | None = None,
                      process_count: int | None = None,
                      sharding: str = "interleaved",
                      barrier_timeout_s: float = 3600.0) -> int:
    """Align a .seq stream across processes; ordered TSV merge on the
    coordinator. Returns pairs processed by this process.

    sharding="interleaved" (default): the file is cut into fixed-size
    byte chunks (pair-boundary aligned via seqio.pair_start_at) dealt
    round-robin to processes — parsing scales with 1/N per process AND
    datasets whose lengths cluster by file position stay load-balanced
    (measured on the 10M-pair workload: contiguous ranges put 6M of the
    10M pairs on one process). The ordered merge walks the chunk runs
    across shards.
    sharding="range": one contiguous byte slice per process; merge is a
    pure shard concatenation. Best when lengths are position-uniform.
    sharding="stride": every process reads the whole stream and takes
    pairs with id % process_count == process_index — input parsing is
    replicated N times; kept as the fully position-independent fallback.
    """
    from quicked_tpu.aligner.batch import align_batch_full

    params = params or QuickedParams()
    if process_index is None or process_count is None:
        process_index, process_count = maybe_initialize_distributed()
    if sharding not in ("interleaved", "range", "stride"):
        raise ValueError(f"unknown sharding mode {sharding!r}")
    marker = seqio.record_marker(input_path)
    if marker is None and sharding in ("interleaved", "range"):
        # The first two lines don't carry two distinct '>'/'<' markers
        # (e.g. a hand-made file using '>' on both lines): record starts
        # can't be recognized by pair_start_at's local byte scan, so a
        # byte-range shard could begin mid-record and silently mispair
        # every record after it. Stride sharding parses the whole stream
        # per process and needs no boundary scan. Every process derives
        # the same fallback from the same file bytes, so the run nonce
        # and shard formats stay consistent.
        sharding = "stride"

    # Stale-run hygiene without a startup ordering requirement: every
    # process derives the same nonce from the run's identity (input
    # bytes identity + the config that shapes the output), .done
    # markers echo it, and the barrier counts only matching markers. A
    # leftover .done from a DIFFERENT run can't satisfy the barrier; a
    # leftover that matches the nonce implies a completed shard of a
    # byte-identical run (alignment is deterministic), which is safe
    # to merge.
    nonce = _run_nonce(input_path, params, process_count, sharding)
    shard_path = f"{output_path}.shard{process_index:05d}"
    if os.path.exists(shard_path + ".done"):
        os.remove(shard_path + ".done")
    if process_index == 0:
        for stale in glob.glob(f"{output_path}.shard*.done"):
            idx = stale[len(output_path) + len(".shard"):].split(".")[0]
            wider = idx.isdigit() and int(idx) >= process_count
            if wider or _read_marker(stale) != nonce:
                os.remove(stale)
                if wider and os.path.exists(stale[:-len(".done")]):
                    os.remove(stale[:-len(".done")])
        # clear shards beyond this run's count even without markers so
        # the merge can't pick up a wider previous run's leftovers
        for stale in glob.glob(f"{output_path}.shard*"):
            idx = stale[len(output_path) + len(".shard"):].split(".")[0]
            if idx.isdigit() and int(idx) >= process_count:
                os.remove(stale)
    n_local = 0
    keyed = sharding == "stride"
    with open(shard_path, "w") as out:

        def emit(res, ids):
            nonlocal n_local
            for k in range(len(res.status)):
                key = f"{ids[k]}\t" if keyed else ""
                if int(res.status[k]) < 0:
                    row = seqio.format_output_error(params.only_score)
                else:
                    row = seqio.format_output_lite(res.score[k],
                                                   res.cigar[k])
                out.write(f"{key}{row}\n")
            n_local += len(ids)

        if sharding == "interleaved":
            size = os.path.getsize(input_path)
            n_chunks = _n_chunks(size)
            for c in range(process_index, n_chunks, process_count):
                lo = seqio.pair_start_at(input_path, c * CHUNK_BYTES,
                                         marker=marker)
                hi = seqio.pair_start_at(input_path,
                                         (c + 1) * CHUNK_BYTES,
                                         marker=marker) \
                    if c + 1 < n_chunks else size
                out.write(f"#{c}\n")
                for batch in seqio.read_seq_batches(
                        input_path, batch_size, start=lo, end=hi):
                    emit(align_batch_full(batch, params),
                         range(len(batch)))
        elif sharding == "range":
            size = os.path.getsize(input_path)
            lo = seqio.pair_start_at(
                input_path, process_index * size // process_count,
                marker=marker)
            hi = seqio.pair_start_at(
                input_path, (process_index + 1) * size // process_count,
                marker=marker) \
                if process_index + 1 < process_count else size
            for batch in seqio.read_seq_batches(input_path, batch_size,
                                                start=lo, end=hi):
                emit(align_batch_full(batch, params), range(len(batch)))
        else:
            batch, batch_ids = [], []
            for gid, pair in enumerate(seqio.read_seq_pairs(input_path)):
                if gid % process_count != process_index:
                    continue
                batch.append(pair)
                batch_ids.append(gid)
                if len(batch) >= batch_size:
                    emit(align_batch_full(batch, params), batch_ids)
                    batch, batch_ids = [], []
            if batch:
                emit(align_batch_full(batch, params), batch_ids)

    # completion marker for the shard-file barrier, echoing the nonce.
    # Written via tmp + rename: the coordinator's stale-marker cleanup
    # can read concurrently, and a half-written marker would mismatch
    # the nonce and be deleted — deadlocking the barrier.
    done_tmp = shard_path + ".done.tmp"
    with open(done_tmp, "w") as f:
        f.write(nonce)
    os.replace(done_tmp, shard_path + ".done")
    if process_index == 0:
        _wait_for_shards(output_path, process_count, nonce,
                         timeout_s=barrier_timeout_s)
        if sharding == "interleaved":
            _merge_chunk_runs(output_path, process_count,
                              _n_chunks(os.path.getsize(input_path)))
        else:
            _merge_shards(output_path, process_count, keyed=keyed)
    return n_local


# interleaved-sharding granularity: small enough that length gradients
# across a multi-GB file spread over all processes, big enough that the
# per-chunk boundary scans and batch restarts are noise
CHUNK_BYTES = 16 << 20


def _n_chunks(size: int) -> int:
    return max(-(-size // CHUNK_BYTES), 1)


def _merge_chunk_runs(output_path: str, process_count: int,
                      n_chunks: int) -> None:
    """Ordered merge of interleaved shards: chunk c's rows live as one
    contiguous run (headed by '#c') in shard c % process_count, and runs
    ascend within each shard, so the merge walks chunks in order copying
    one run at a time — O(total) streaming, O(process_count) memory."""
    shards = [f"{output_path}.shard{i:05d}" for i in range(process_count)]
    files = [open(p) for p in shards]
    heads = [f.readline() for f in files]
    with open(output_path, "w") as out:
        for c in range(n_chunks):
            fi = c % process_count
            f = files[fi]
            if heads[fi] != f"#{c}\n":
                raise RuntimeError(
                    f"shard {fi}: expected chunk header #{c}, got "
                    f"{heads[fi]!r}")
            while True:
                line = f.readline()
                if not line or line.startswith("#"):
                    heads[fi] = line
                    break
                out.write(line)
    for f, p in zip(files, shards):
        f.close()
        os.remove(p)
        if os.path.exists(p + ".done"):
            os.remove(p + ".done")


def _run_nonce(input_path: str, params, process_count: int,
               sharding: str) -> str:
    """Deterministic run identity every process derives locally: the
    input file's identity plus every config knob that shapes the output
    bytes (params, process_count, sharding mode, chunking). Two runs
    with the same nonce produce byte-identical shards."""
    import hashlib

    st = os.stat(input_path)
    key = "\x1f".join([
        os.path.realpath(input_path), str(st.st_size),
        str(st.st_mtime_ns), str(process_count), sharding,
        str(CHUNK_BYTES), repr(params)])
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _read_marker(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def _wait_for_shards(output_path: str, process_count: int, nonce: str,
                     timeout_s: float = 3600.0) -> None:
    """File-based barrier on the shared filesystem: the coordinator
    merges only after every process has marked its shard complete WITH
    this run's nonce (a stale .done from a crashed run cannot count)."""
    import time

    expected = [f"{output_path}.shard{i:05d}.done"
                for i in range(process_count)]

    def _n_done():
        return sum(_read_marker(p) == nonce for p in expected)

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if _n_done() >= process_count:
            return
        time.sleep(0.5)
    raise TimeoutError(
        f"distributed merge: only {_n_done()}"
        f"/{process_count} shards completed within {timeout_s}s")


def _merge_shards(output_path: str, process_count: int,
                  keyed: bool = True) -> None:
    """Input-ordered streaming merge of per-process shard files.

    Range shards (keyed=False) are contiguous slices of the input in
    process order, so the merge is a streaming concatenation. Strided
    shards (keyed=True) carry a global-id column and are each written in
    ascending id order, so a heap over one head line per shard merges N
    shards in O(total) time and O(process_count) memory — both shapes
    sized for the 10M-pair distributed workload, where materialising all
    rows (scores + CIGARs) in memory would not fit.
    """
    import heapq
    import shutil

    shards = [f"{output_path}.shard{i:05d}" for i in range(process_count)]
    if not keyed:
        with open(output_path, "wb") as out:
            for p in shards:
                with open(p, "rb") as f:
                    shutil.copyfileobj(f, out, 8 << 20)
    else:
        files = [open(p) for p in shards]
        heap = []
        for fi, f in enumerate(files):
            line = f.readline()
            if line:
                gid, rest = line.split("\t", 1)
                heap.append((int(gid), fi, rest))
        heapq.heapify(heap)
        with open(output_path, "w") as out:
            while heap:
                _, fi, rest = heapq.heappop(heap)
                out.write(rest)
                line = files[fi].readline()
                if line:
                    gid, rest = line.split("\t", 1)
                    heapq.heappush(heap, (int(gid), fi, rest))
        for f in files:
            f.close()
    for p in shards:
        os.remove(p)
        if os.path.exists(p + ".done"):
            os.remove(p + ".done")
