"""Async device-kernel warmup: first-contact latency control.

The reference starts aligning instantly (zero compile); a device lane
that stalls the FIRST call of a shape for seconds of XLA or Triton
compilation is a product defect. This module lets the venue router serve a cold
bucket shape from the host C lane while a background thread compiles
and warms the device kernel for that shape; subsequent calls with the
same shape take the device as usual.

Semantics are venue-only: both lanes are bit-exact, so deferral can
never change results — only where the first batch of a given shape
executes. `QUICKED_TPU_ASYNC_WARMUP=0` disables deferral (cold calls
block on compilation, the pre-round-4 behavior).

One warmup worker thread: device warmups serialize (a single XLA
client compiles one program at a time anyway).
"""

from __future__ import annotations

import os
import threading
import traceback

_LOCK = threading.Lock()
_WARMED: set = set()
_INFLIGHT: set = set()
_QUEUE: list = []
_WORKER: threading.Thread | None = None
_CV = threading.Condition(_LOCK)
_SHUTDOWN = False
_HOOKED = False


def enabled() -> bool:
    return os.environ.get("QUICKED_TPU_ASYNC_WARMUP", "1") == "1"


def _worker_main() -> None:
    while True:
        with _CV:
            while not _QUEUE and not _SHUTDOWN:
                _CV.wait()
            if _SHUTDOWN and not _QUEUE:
                return
            key, fn = _QUEUE.pop(0)
        try:
            fn()
        except Exception:  # a failed warmup must not kill the worker
            if os.environ.get("QUICKED_TPU_DEBUG"):
                traceback.print_exc()
        finally:
            with _CV:
                _INFLIGHT.discard(key)
                _WARMED.add(key)   # don't retry a failing shape forever;
                                   # the next real call runs it inline


def mark_warm(key) -> None:
    """Record that `key`'s kernel has executed (compiled) in-process."""
    with _CV:
        _WARMED.add(key)


def is_warm(key) -> bool:
    with _CV:
        return key in _WARMED


def defer_cold(key, warm_fn) -> bool:
    """True -> the caller should take its host fallback this time; the
    device kernel for `key` is being warmed in the background via
    `warm_fn` (called once, results discarded). False -> `key` is warm
    (or deferral is off): run on the device now."""
    if not enabled():
        return False
    global _WORKER
    with _CV:
        if key in _WARMED:
            return False
        if key not in _INFLIGHT:
            _INFLIGHT.add(key)
            _QUEUE.append((key, warm_fn))
            if _WORKER is None or not _WORKER.is_alive():
                _WORKER = _start_worker()
            _CV.notify()
        return True


#: Exit code os._exit uses if the in-flight warmup outlasts the exit
#: bound (CLIs record theirs via note_exit_code; default 0).
_EXIT_CODE = 0


def note_exit_code(code: int) -> None:
    """Record the process's intended exit code for the bounded-drain
    escape hatch in _drain_at_shutdown (os._exit cannot know it)."""
    global _EXIT_CODE
    _EXIT_CODE = int(code) if code else 0


def _drain_at_shutdown() -> None:
    """Interpreter-exit hook (threading._register_atexit: runs at the
    START of threading._shutdown, before non-daemon joins): abandon
    queued warmups — they can only ever help THIS process, which is
    exiting — and let the worker finish its one in-flight compile and
    return. A daemon worker parked inside an XLA compile instead
    ABORTS the whole interpreter at finalization (pthread_exit's
    forced unwind hits a catch(...) in the C++ runtime: 'FATAL:
    exception not rethrown', observed on a 1 Mbp one-shot CLI run
    whose deep Hirschberg levels enqueued a ~60 s hsplit-op compile).

    The subsequent non-daemon join is BOUNDED here: a compile stuck on
    a wedged device link could otherwise hang process exit for tens of
    minutes. Past QUICKED_TPU_WARMUP_EXIT_WAIT_S (default 30 s) the
    process hard-exits via os._exit — outputs were written by the main
    thread already, and a hard exit cannot be force-unwound.
    """
    global _SHUTDOWN
    with _CV:
        _SHUTDOWN = True
        _QUEUE.clear()
        _CV.notify_all()
        busy = bool(_INFLIGHT)
    if not busy:
        return
    bound = float(os.environ.get("QUICKED_TPU_WARMUP_EXIT_WAIT_S", "30"))
    if wait_idle(timeout=bound):
        return
    import sys

    print("quicked_tpu: abandoning a background kernel warmup still "
          f"running after {bound:.0f}s at exit", file=sys.stderr)
    sys.stderr.flush()
    try:
        sys.stdout.flush()
    except (OSError, ValueError):
        pass
    os._exit(_EXIT_CODE)


def _start_worker() -> threading.Thread:
    """Start the warmup worker. Non-daemon + shutdown hook where the
    private-but-stable threading._register_atexit exists (3.9+): the
    interpreter then waits for the in-flight compile instead of
    force-unwinding it. Daemon fallback otherwise (the pre-fix
    behavior) so exotic runtimes still work."""
    global _HOOKED
    register = getattr(threading, "_register_atexit", None)
    if register is not None:
        try:
            if not _HOOKED:
                register(_drain_at_shutdown)
                _HOOKED = True
            w = threading.Thread(target=_worker_main,
                                 name="quicked-warmup", daemon=False)
            w.start()
            return w
        except RuntimeError:
            pass    # already shutting down: fall through to daemon
    w = threading.Thread(target=_worker_main, name="quicked-warmup",
                         daemon=True)
    w.start()
    return w


def wait_idle(timeout: float = 120.0) -> bool:
    """Block until no warmups are queued or in flight (tests; also lets
    a benchmark separate 'cold + warming' from 'steady state')."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with _CV:
            if not _QUEUE and not _INFLIGHT:
                return True
        time.sleep(0.01)
    return False


def reset() -> None:
    """Test hook: forget all warm/inflight state (queued fns still run)."""
    with _CV:
        _WARMED.clear()
        _INFLIGHT.clear()
