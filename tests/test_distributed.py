"""Distributed driver tests: shard equivalence — N simulated processes
over the same input produce the identical ordered output as 1 process."""

import os

import numpy as np

from quicked_tpu import generate, seqio
from quicked_tpu.parallel.distributed import distributed_align
from quicked_tpu.params import QuickedAlgo, QuickedParams


def test_shard_equivalence(tmp_path):
    pairs = list(generate.generate_pairs(12, 150, error=0.1, seed=77))
    seq = str(tmp_path / "in.seq")
    seqio.write_seq_pairs(seq, pairs)
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)

    out1 = str(tmp_path / "out1.tsv")
    n = distributed_align(seq, out1, params, process_index=0,
                         process_count=1)
    assert n == 12

    # simulate 3 processes sequentially over the same shared directory
    # (coordinator last, so its merge sees every shard), in both
    # sharding modes — byte-range slices and strided ids
    with open(out1) as f1:
        ref = f1.read()
    for mode in ("interleaved", "range", "stride"):
        out3 = str(tmp_path / f"out3_{mode}.tsv")
        total = 0
        for pi in (1, 2, 0):
            total += distributed_align(seq, out3, params, process_index=pi,
                                       process_count=3, sharding=mode)
        assert total == 12
        with open(out3) as f3:
            assert f3.read() == ref


def test_interleaved_many_small_chunks(tmp_path, monkeypatch):
    # chunk size smaller than a record: empty chunks, chunk runs split
    # across processes, ordered merge must still reproduce input order
    from quicked_tpu.parallel import distributed as dist

    monkeypatch.setattr(dist, "CHUNK_BYTES", 64)
    pairs = list(generate.generate_pairs(10, 90, error=0.1, seed=80))
    seq = str(tmp_path / "in.seq")
    seqio.write_seq_pairs(seq, pairs)
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)
    out1 = str(tmp_path / "out1.tsv")
    distributed_align(seq, out1, params, process_index=0, process_count=1,
                      sharding="stride")
    out3 = str(tmp_path / "out3.tsv")
    total = 0
    for pi in (2, 1, 0):
        total += distributed_align(seq, out3, params, process_index=pi,
                                   process_count=3, sharding="interleaved")
    assert total == 10
    with open(out1) as f1, open(out3) as f3:
        assert f1.read() == f3.read()


def test_pair_start_at(tmp_path):
    pairs = [("ACGT" * k, "ACGA" * k) for k in range(1, 6)]
    seq = str(tmp_path / "in.seq")
    seqio.write_seq_pairs(seq, pairs)
    size = os.path.getsize(seq)
    data = open(seq, "rb").read()
    starts = [0]
    for i, ch in enumerate(data):
        if ch == ord(">") and data[i - 1] == ord("\n"):
            starts.append(i)
    # every byte position maps to the next true record start
    for pos in range(size + 2):
        expect = next((s for s in starts if s >= pos), size)
        assert seqio.pair_start_at(seq, pos) == expect
    # tiny chunk size exercises the cross-chunk "\n>" boundary carry
    mid = starts[2] - 1
    assert seqio.pair_start_at(seq, mid, chunk_bytes=1) == starts[2]


def test_flipped_dataset_sharding(tmp_path):
    # length_diff < 1 datasets are written '<pattern/>text'
    # (generate_dataset.c:399-409: longer sequence is the pattern), so
    # record starts are marked '<' — byte-range sharding must detect
    # the marker or it would cut records in half and silently mispair
    # everything after the first chunk boundary
    pairs = list(generate.generate_pairs(10, 120, error=0.1, seed=83,
                                         length_diff=0.8))
    assert all(len(p) > len(t) for p, t in pairs)
    seq = str(tmp_path / "flipped.seq")
    with open(seq, "w") as f:
        for p, t in pairs:
            f.write(f"<{p}\n>{t}\n")
    assert seqio.record_marker(seq) == b"<"
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)
    out1 = str(tmp_path / "o1.tsv")
    distributed_align(seq, out1, params, process_index=0, process_count=1)
    for mode in ("interleaved", "range"):
        outn = str(tmp_path / f"on_{mode}.tsv")
        total = 0
        for pi in (2, 1, 0):
            total += distributed_align(seq, outn, params, process_index=pi,
                                       process_count=3, sharding=mode)
        assert total == 10
        with open(out1) as f1, open(outn) as fn:
            assert f1.read() == fn.read()


def test_ambiguous_marker_falls_back_to_stride(tmp_path):
    # both lines marked '>' (hand-made file): no local record-start
    # signal, so byte-range modes must fall back to stride (parse all,
    # take id % N) instead of mispairing records
    pairs = list(generate.generate_pairs(6, 80, error=0.1, seed=84))
    seq = str(tmp_path / "ambig.seq")
    with open(seq, "w") as f:
        for p, t in pairs:
            f.write(f">{p}\n>{t}\n")
    assert seqio.record_marker(seq) is None
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)
    out1 = str(tmp_path / "o1.tsv")
    distributed_align(seq, out1, params, process_index=0, process_count=1,
                      sharding="stride")
    outn = str(tmp_path / "on.tsv")
    total = 0
    for pi in (1, 0):
        total += distributed_align(seq, outn, params, process_index=pi,
                                   process_count=2, sharding="interleaved")
    assert total == 6
    with open(out1) as f1, open(outn) as fn:
        assert f1.read() == fn.read()


def test_range_sharding_more_processes_than_pairs(tmp_path):
    pairs = list(generate.generate_pairs(3, 80, error=0.05, seed=79))
    seq = str(tmp_path / "in.seq")
    seqio.write_seq_pairs(seq, pairs)
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)
    out1 = str(tmp_path / "out1.tsv")
    distributed_align(seq, out1, params, process_index=0, process_count=1)
    outn = str(tmp_path / "outn.tsv")
    total = 0
    for pi in (4, 3, 2, 1, 0):
        total += distributed_align(seq, outn, params, process_index=pi,
                                   process_count=5)
    assert total == 3
    with open(out1) as f1, open(outn) as fn:
        assert f1.read() == fn.read()


def test_concurrent_processes(tmp_path):
    # real concurrent processes over a shared directory: the coordinator
    # must block on the shard barrier until every worker finishes
    import subprocess
    import sys

    pairs = list(generate.generate_pairs(9, 120, error=0.1, seed=78))
    seq = str(tmp_path / "in.seq")
    seqio.write_seq_pairs(seq, pairs)
    out = str(tmp_path / "out.tsv")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu');"
        "sys.path.insert(0, {repo!r});"
        "from quicked_tpu.parallel.distributed import distributed_align;"
        "from quicked_tpu.params import QuickedParams, QuickedAlgo;"
        "distributed_align({seq!r}, {out!r}, "
        "QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30), "
        "process_index=int(sys.argv[1]), process_count=3)"
    ).format(repo=repo, seq=seq, out=out)
    env = dict(os.environ,
               JAX_COMPILATION_CACHE_DIR=os.path.join(repo, ".jax_cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pi)],
                              env=env, cwd=repo,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for pi in range(3)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    with open(out) as f:
        lines = f.read().strip().split("\n")
    assert len(lines) == 9
    for line in lines:
        assert "ERROR" not in line


def test_crlf_input_shard_accounting(tmp_path):
    # CRLF line endings: byte-offset shard budgets must count raw bytes
    # (universal-newline translation used to undercount by 1/line and
    # overrun shard ends, duplicating pairs). The '\r' stays inside the
    # sequence like the reference's getline parser.
    pairs = list(generate.generate_pairs(8, 60, error=0.1, seed=82))
    seq = str(tmp_path / "crlf.seq")
    with open(seq, "wb") as f:
        for p, t in pairs:
            f.write(f">{p}\r\n<{t}\r\n".encode())
    params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)
    out1 = str(tmp_path / "o1.tsv")
    n1 = distributed_align(seq, out1, params, process_index=0,
                           process_count=1, sharding="range")
    assert n1 == 8
    out3 = str(tmp_path / "o3.tsv")
    total = 0
    for pi in (2, 1, 0):
        total += distributed_align(seq, out3, params, process_index=pi,
                                   process_count=3, sharding="range")
    assert total == 8   # no duplicated boundary pairs
    with open(out1) as f1, open(out3) as f3:
        assert f1.read() == f3.read()


def _run_jax_distributed(tmp_path, n_procs: int, n_pairs: int,
                         seed: int) -> str:
    """Launch a REAL n-process jax.distributed run on CPU: each process
    discovers (index, count) from the coordination service through
    maybe_initialize_distributed (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID), not explicit arguments — the
    multi-host launch path BASELINE workload 5 prescribes, minus the
    extra physical hosts. Returns the merged output text."""
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    pairs = list(generate.generate_pairs(n_pairs, 100, error=0.1,
                                         seed=seed))
    seq = str(tmp_path / f"in{n_procs}.seq")
    seqio.write_seq_pairs(seq, pairs)
    out = str(tmp_path / f"out{n_procs}.tsv")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu');"
        "sys.path.insert(0, {repo!r});"
        "from quicked_tpu.parallel.distributed import ("
        "distributed_align, maybe_initialize_distributed);"
        "from quicked_tpu.params import QuickedParams, QuickedAlgo;"
        "pi, pc = maybe_initialize_distributed();"
        "assert pc == {n!r}, (pi, pc);"
        "distributed_align({seq!r}, {out!r}, "
        "QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30))"
    ).format(repo=repo, seq=seq, out=out, n=n_procs)
    from quicked_tpu.utils.cache import compile_cache_dir
    env_base = dict(os.environ,
                    JAX_COMPILATION_CACHE_DIR=compile_cache_dir(),
                    JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1",
                    JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    JAX_NUM_PROCESSES=str(n_procs))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(env_base, JAX_PROCESS_ID=str(pi)),
                              cwd=repo, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for pi in range(n_procs)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()[-2000:]
    with open(out) as f:
        text = f.read()
    lines = text.strip().split("\n")
    assert len(lines) == n_pairs
    for line in lines:
        assert "ERROR" not in line
    return text


def test_two_process_jax_distributed(tmp_path):
    _run_jax_distributed(tmp_path, 2, 8, seed=91)


def test_three_process_jax_distributed_uneven(tmp_path):
    """3 real jax.distributed processes over 10 pairs (uneven shards)
    must produce the byte-identical ordered merge of a 1-process run."""
    out3 = _run_jax_distributed(tmp_path, 3, 10, seed=92)
    pairs = list(generate.generate_pairs(10, 100, error=0.1, seed=92))
    seq = str(tmp_path / "in_ref.seq")
    seqio.write_seq_pairs(seq, pairs)
    out1 = str(tmp_path / "out_ref.tsv")
    distributed_align(seq, out1, QuickedParams(algo=QuickedAlgo.BANDED,
                                               bandwidth=30),
                      process_index=0, process_count=1)
    with open(out1) as f:
        assert f.read() == out3


def test_local_device_ids_from_launch_env(monkeypatch):
    """Several processes on one host: each is limited to the card the
    launcher names in JAX_LOCAL_DEVICE_IDS (unset: JAX's default, all
    local devices)."""
    import jax

    from quicked_tpu.parallel import distributed as dist

    seen = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.append(kw))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "1")
    dist.maybe_initialize_distributed()
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS")
    dist.maybe_initialize_distributed()
    assert [kw["local_device_ids"] for kw in seen] == [[1], None]
    assert all(kw["process_id"] == 1 and kw["num_processes"] == 2
               for kw in seen)
