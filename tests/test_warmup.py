"""Async device-kernel warmup (utils/warmup): cold bucket shapes are
served from the host lane while the device kernel compiles in the
background — first-contact latency control, venue-only semantics."""

import threading

import numpy as np
import pytest


from quicked_tpu import native
from quicked_tpu.utils import warmup

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_warmup_state():
    warmup.reset()
    yield
    warmup.wait_idle()
    warmup.reset()


def test_defer_cold_runs_warm_fn_once_then_inline():
    calls = []
    done = threading.Event()
    release = threading.Event()     # holds the warmup in flight

    def warm_fn():
        release.wait(30)
        calls.append(threading.current_thread().name)
        done.set()

    key = ("fam", 1, 2)
    assert warmup.defer_cold(key, warm_fn) is True      # cold: defer
    assert warmup.defer_cold(key, warm_fn) is True      # still inflight
    release.set()
    assert done.wait(30)
    assert warmup.wait_idle(30)
    assert warmup.defer_cold(key, warm_fn) is False     # warm: inline
    assert len(calls) == 1
    assert calls[0] == "quicked-warmup"                  # off-thread


def test_defer_cold_disabled_by_env(monkeypatch):
    monkeypatch.setenv("QUICKED_TPU_ASYNC_WARMUP", "0")
    assert warmup.defer_cold(("fam", 9), lambda: None) is False


def test_failed_warmup_does_not_retry_forever():
    def boom():
        raise RuntimeError("compile failed")

    key = ("bad", 0)
    assert warmup.defer_cold(key, boom) is True
    assert warmup.wait_idle(30)
    # the shape is treated as warm afterwards: the next real call runs
    # the kernel inline (and surfaces the real error to the caller)
    assert warmup.defer_cold(key, boom) is False


def test_mark_warm_skips_deferral():
    key = ("fam", 3)
    warmup.mark_warm(key)
    assert warmup.defer_cold(key, lambda: None) is False


@pytest.mark.skipif(not native.available(), reason="no C toolchain")
def test_windowed_cold_deferral_routes_host_then_device(monkeypatch):
    """On an accelerator platform, the first windowed batch of a given
    bucket shape is served by the host C kernel (bit-exact) while the
    device kernel warms; after warmup the same shape runs inline — and
    both give identical results."""
    from quicked_tpu.aligner import batch as ab
    from quicked_tpu.aligner import cascade, lanes
    from quicked_tpu import generate
    from quicked_tpu.ops import myers_np

    # the GPU's lane table (device windowed buckets); execution still
    # lands on the CPU backend
    monkeypatch.setattr(lanes, "current", lambda: lanes.for_platform("gpu"))

    pairs = list(generate.generate_pairs(4, 200, error=0.1, seed=91))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]

    before = ab.venue_snapshot()
    s1, h1 = cascade.windowed_score_batch(pats, txts, 40, 2, 1)
    mid = ab.venue_snapshot()
    assert mid.get("windowed_warming", 0) == \
        before.get("windowed_warming", 0) + 1
    assert warmup.wait_idle(120)
    s2, h2 = cascade.windowed_score_batch(pats, txts, 40, 2, 1)
    after = ab.venue_snapshot()
    # second call: no new warming event (shape is warm, ran inline)
    assert after.get("windowed_warming", 0) == \
        mid.get("windowed_warming", 0)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(h1, h2)
    for i, (p, t) in enumerate(pairs):
        ms, _, mh = myers_np.windowed_compute(p, t, 40, 2, 1, True)
        assert int(s1[i]) == ms and int(h1[i]) == mh


def test_shutdown_drains_inflight_and_abandons_queue(tmp_path):
    """Interpreter exit with a warmup IN FLIGHT must (a) not abort the
    process (a daemon worker parked inside an XLA compile force-unwinds
    C++ frames at finalization: 'FATAL: exception not rethrown' —
    observed on a 1 Mbp one-shot CLI run), (b) finish the in-flight fn,
    and (c) abandon fns still queued behind it."""
    import subprocess
    import sys

    inflight = tmp_path / "inflight.done"
    queued = tmp_path / "queued.done"
    started = tmp_path / "inflight.started"
    script = tmp_path / "exit_while_warming.py"
    script.write_text(f"""
import os, sys, time
sys.path.insert(0, {repr(REPO)})
from quicked_tpu.utils import warmup

def slow():
    open({repr(str(started))}, "w").write("x")
    time.sleep(1.0)
    open({repr(str(inflight))}, "w").write("x")

def later():
    open({repr(str(queued))}, "w").write("x")

assert warmup.defer_cold("k1", slow)
# deterministic: wait until the worker has actually STARTED k1 (a
# fixed sleep races on loaded hosts and the drain would then abandon
# both entries)
for _ in range(500):
    if os.path.exists({repr(str(started))}):
        break
    time.sleep(0.01)
assert os.path.exists({repr(str(started))})
assert warmup.defer_cold("k2", later)
# exit immediately: k1 is mid-flight, k2 still queued
""")
    r = subprocess.run([sys.executable, str(script)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-1000:]
    assert inflight.exists(), "in-flight warmup was not drained"
    assert not queued.exists(), "queued warmup should be abandoned"
