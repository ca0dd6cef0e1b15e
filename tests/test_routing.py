"""Venue-router units: the probe-fed estimates that pick host-C vs
device kernels per batch (aligner/batch.py). The GPU branches run on
the card in chip_smoke.py; these tests pin the estimate math and the
budget-derived native-lane ceiling on CPU."""

import os

import numpy as np
import pytest

from quicked_tpu import generate
from quicked_tpu.aligner import batch as ab
from quicked_tpu.aligner.cascade import _native_fast_max
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.params import HIRSCHBERG_BUFFER_SIZE

# a device kernel rate for the estimate math (advances/s)
DEV_RATE = 5.7e8


def _batch(n=4, length=600, bw=15, seed=11):
    pairs = list(generate.generate_pairs(n, length, error=0.1, seed=seed))
    cutoffs = [max(len(p), len(t)) * bw // 100 for p, t in pairs]
    return prepare_banded_batch([p for p, _ in pairs],
                                [t for _, t in pairs], cutoffs, full=False)


def test_native_fast_max_is_budget_boundary():
    for bw in (5, 15, 50, 100):
        L = _native_fast_max(bw)
        ebb = (L * bw // 100) // 64 + 2
        assert ebb * L * 16 <= HIRSCHBERG_BUFFER_SIZE
        L1 = L + 1
        ebb1 = (L1 * bw // 100) // 64 + 2
        assert ebb1 * L1 * 16 > HIRSCHBERG_BUFFER_SIZE
    # monotone in bandwidth: wider bands -> shorter ceiling
    assert _native_fast_max(5) > _native_fast_max(15) > _native_fast_max(50)


def test_deep_band_advances_bounds_work():
    b = _batch(n=3, length=640)
    adv = ab._deep_band_advances(b)
    # each live pair contributes tfinish * (cutoff//64 + 1) advances
    want = sum(int(b.tfinish[i]) * (int(b.cutoff[i]) // 64 + 1)
               for i in range(3))
    assert adv == float(want)


def test_score_device_estimate_scales_with_link(monkeypatch):
    b = _batch()
    adv = ab._deep_band_advances(b)
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.001])
    monkeypatch.setattr(ab, "_LINK_MBPS", [10_000.0])   # PCIe-class
    fast = ab._score_device_est_s(b, adv, DEV_RATE)
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])       # dev tunnel
    slow = ab._score_device_est_s(b, adv, DEV_RATE)
    assert slow > fast
    bytes_up = (b.peq_lo.nbytes + b.peq_hi.nbytes + b.lm_lo.nbytes
                + b.lm_hi.nbytes + b.text.nbytes // 4)  # text packed
    np.testing.assert_allclose(slow - fast,
                               bytes_up / 20e6 - bytes_up / 10e9,
                               rtol=1e-6)


def test_venue_decision_flips_with_link(monkeypatch):
    """On a fast link with low dispatch latency a big batch favors the
    device; through a slow high-latency link the same batch favors the
    host — the decision the GPU branch of _run_banded_auto makes."""
    b = _batch(n=32, length=30_000, bw=15)
    adv = ab._deep_band_advances(b)
    cores = 4
    est_host = adv / (ab.HOST_ADV_PER_S_PER_CORE * cores)
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.0005])
    monkeypatch.setattr(ab, "_LINK_MBPS", [10_000.0])
    assert ab._score_device_est_s(b, adv, DEV_RATE) < est_host
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.5])
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    assert ab._score_device_est_s(b, adv, DEV_RATE) > est_host


def test_probe_cache_roundtrip_real_files(tmp_path, monkeypatch):
    """Non-mocked probe-cache coverage (a past regression: batch.py
    used `os` without importing it, so every device venue decision
    crashed while the mocked tests stayed green). Executes the real
    _probe_cache_{path,get,put} against a tmp cache dir."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("QUICKED_TPU_PROBE_CACHE", "1")
    assert ab._probe_cache_path() == str(tmp_path / "device_probes.json")
    assert ab._probe_cache_get("readback_mbps") is None
    ab._probe_cache_put("readback_mbps", 123.5)
    assert ab._probe_cache_get("readback_mbps") == 123.5
    # a second key coexists in the same file
    ab._probe_cache_put("other", 7.0)
    assert ab._probe_cache_get("readback_mbps") == 123.5
    assert ab._probe_cache_get("other") == 7.0
    # TTL expiry: a stale timestamp misses
    import json
    path = ab._probe_cache_path()
    data = json.load(open(path))
    data["readback_mbps"]["ts"] -= ab._PROBE_TTL_S + 1
    json.dump(data, open(path, "w"))
    assert ab._probe_cache_get("readback_mbps") is None
    # disabled cache: put/get are no-ops
    monkeypatch.setenv("QUICKED_TPU_PROBE_CACHE", "0")
    ab._probe_cache_put("x", 1.0)
    assert ab._probe_cache_get("other") is None


def test_device_probes_execute_for_real(tmp_path, monkeypatch):
    """Run _device_readback_mbps / _device_dispatch_s end-to-end (on the
    CPU platform) with an empty memo, touching the real probe + cache
    write; the second call must serve the memo."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(ab, "_DISPATCH_S", [])
    mbps = ab._device_readback_mbps()
    assert mbps > 0.0
    assert ab._device_readback_mbps() == mbps   # memoized
    assert ab._probe_cache_get("readback_mbps") == mbps  # persisted
    disp = ab._device_dispatch_s()
    assert disp > 0.0
    assert ab._device_dispatch_s() == disp

    # a fresh process (fresh memo) with a seeded cache must read the
    # cached value instead of re-probing
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    ab._probe_cache_put("readback_mbps", 42.0)
    assert ab._device_readback_mbps() == 42.0


def test_score_device_estimate_uses_real_probes(tmp_path, monkeypatch):
    """_score_device_est_s with NO monkeypatched probe constants — the
    exact call chain that crashed at round-2 HEAD
    (_run_banded_auto -> _score_device_est_s -> _device_readback_mbps
    -> _probe_cache_get -> os.environ)."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(ab, "_DISPATCH_S", [])
    b = _batch()
    adv = ab._deep_band_advances(b)
    est = ab._score_device_est_s(b, adv, DEV_RATE)
    assert est > 0.0 and np.isfinite(est)


def test_kernel_rate_resolution_order(tmp_path, monkeypatch):
    """_kernel_rate: process memo -> probe cache -> calibration ->
    (host only) the per-core floor. With calibration off and an empty
    cache the host floor comes back and a device family raises — a
    device is never given an assumed rate; a cached entry serves; the
    memo serves without re-reading the cache."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("QUICKED_TPU_CALIBRATE", "0")
    monkeypatch.setattr(ab, "_RATES", {})
    cores = max(os.cpu_count() or 1, 1)
    assert ab._kernel_rate("host") == ab.HOST_ADV_PER_S_PER_CORE * cores
    for family in ("triton", "cscan"):
        with pytest.raises(RuntimeError, match="no measured rate"):
            ab._kernel_rate(family)
    ab._probe_cache_put("adv_rate_triton", 2.5e10)
    assert ab._kernel_rate("triton") == 2.5e10
    # a cached rate overrides the fallback (fresh memo = fresh process)
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 123.0)
    assert ab._kernel_rate("host") == 123.0
    # the memo serves without re-reading the cache file
    ab._probe_cache_put("adv_rate_host", 456.0)
    assert ab._kernel_rate("host") == 123.0


def test_fake_rate_cache_entry_flips_venue_decision(tmp_path, monkeypatch):
    """A fake kernel-rate cache entry flips the venue decision through
    the REAL _kernel_rate chain (no rate monkeypatching) — proving the
    router consumes calibration results, not static constants."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("QUICKED_TPU_CALIBRATE", "0")
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.001])
    monkeypatch.setattr(ab, "_LINK_MBPS", [10_000.0])
    b = _batch(n=4, length=30_000)
    ab._probe_cache_put("adv_rate_cscan", DEV_RATE)
    ab._probe_cache_put("adv_rate_triton", 1e10)
    # an implausibly fast host entry routes deep bands to the host
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 1e15)
    assert ab._prefer_host_deep(b) is True
    # an implausibly slow one routes them to the device
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 1.0)
    assert ab._prefer_host_deep(b) is False
    # same flip for the shallow (pairs-as-lanes) decision
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 1e15)
    assert ab._prefer_host_shallow(b, n_live=4) is True
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 1.0)
    assert ab._prefer_host_shallow(b, n_live=4) is False


def test_host_calibration_measures_and_persists(tmp_path, monkeypatch):
    """First-use host calibration runs the real C kernel timing and
    persists the measured rate with the long TTL."""
    from quicked_tpu.ops.banded_native import native_available
    if not native_available():
        pytest.skip("native lib unavailable")
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("QUICKED_TPU_CALIBRATE", "1")
    monkeypatch.setattr(ab, "_RATES", {})
    rate = ab._kernel_rate("host")
    assert rate > 1e6                       # a real advances/s figure
    assert rate != ab.HOST_ADV_PER_S_PER_CORE * (os.cpu_count() or 1)
    assert ab._probe_cache_get("adv_rate_host", ttl=ab._RATE_TTL_S) == rate
    # the short probe TTL must NOT apply to rates: backdate past the
    # probe TTL but within the rate TTL and it still serves
    import json
    path = ab._probe_cache_path()
    data = json.load(open(path))
    data["adv_rate_host"]["ts"] -= ab._PROBE_TTL_S + 10
    json.dump(data, open(path, "w"))
    monkeypatch.setattr(ab, "_RATES", {})
    monkeypatch.setenv("QUICKED_TPU_CALIBRATE", "0")
    assert ab._kernel_rate("host") == rate


def test_mixed_lane_batch_records_one_total_lap(monkeypatch):
    # A batch split across the native and staged lanes must record ONE
    # timers.total lap per call (two would split the printed mean), and
    # every pair must carry run_quicked's WIP status (quicked.c:305).
    from quicked_tpu.aligner import cascade, lanes
    from quicked_tpu.params import QuickedParams, QuickedStatus
    from quicked_tpu.utils.profiler import PhaseTimers

    monkeypatch.setenv("QUICKED_TPU_NATIVE_CASCADE_MAX_LEN", "16")
    # a device table whose score kernel is the XLA scan: engages the
    # length split without routing the staged lane onto the compiled
    # Triton kernel (CPU backend); measured-looking rates, no probes
    monkeypatch.setattr(lanes, "current", lambda: lanes.Lanes(
        platform="gpu", host_first=False, score_kernel="xla"))
    monkeypatch.setattr(ab, "_RATES", {"host": 1e9, "triton": 1e10,
                                       "cscan": 1e9})
    pairs = [("ACGTACGT", "ACGTACGT"),                      # native lane
             ("ACGT" * 16, "ACGT" * 15 + "ACGA")]           # staged lane
    timers = PhaseTimers()
    res = cascade.quicked_cascade_batch(pairs, QuickedParams(),
                                        timers=timers)
    assert timers.total.count.samples == 1
    assert all(st == QuickedStatus.QUICKED_WIP for st in res.status)
    assert int(res.score[0]) == 0 and res.cigar[0] == "8M"


def test_outage_link_probe_not_persisted(tmp_path, monkeypatch):
    """A sub-1 MB/s link probe (a transient outage / cross-process
    contention, not an operating point) must serve THIS process but
    stay out of the cross-process cache; a healthy reading persists."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    import time as _time

    class SlowClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 10.0          # 8 MB / 10 s = 0.8 MB/s
            return self.t

    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(_time, "perf_counter", SlowClock())
    mbps = ab._device_readback_mbps()
    assert mbps < 1.0
    assert ab._probe_cache_get("readback_mbps") is None  # not cached
    assert ab._device_readback_mbps() == mbps            # memoized

    class FastClock(SlowClock):
        def __call__(self):
            self.t += 0.5           # 8 MB / 0.5 s = 16 MB/s
            return self.t

    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(_time, "perf_counter", FastClock())
    mbps = ab._device_readback_mbps()
    assert mbps >= 1.0
    assert ab._probe_cache_get("readback_mbps") == mbps  # cached


def test_device_calibration_declines_without_device_lanes(tmp_path, monkeypatch):
    """With calibration ON but no device lanes (the CPU table), device
    calibration raises instead of assuming a rate, and persists
    nothing (a made-up rate in the cache would mask a later real
    calibration)."""
    from quicked_tpu.aligner import lanes

    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("QUICKED_TPU_CALIBRATE", "1")
    monkeypatch.setattr(ab, "_RATES", {})
    with pytest.raises(lanes.UnsupportedPlatform):
        ab._kernel_rate("cscan")
    assert ab._probe_cache_get("adv_rate_cscan",
                               ttl=ab._RATE_TTL_S) is None


def test_prefer_staged_short_only_when_forced(monkeypatch):
    """Short pairs take the native C lane unless the staged device
    cascade is forced (QUICKED_TPU_STAGED_SHORT=1)."""
    from quicked_tpu.aligner import cascade as cs

    monkeypatch.delenv("QUICKED_TPU_STAGED_SHORT", raising=False)
    assert not cs._prefer_staged_short()
    monkeypatch.setenv("QUICKED_TPU_STAGED_SHORT", "1")
    assert cs._prefer_staged_short()
    monkeypatch.setenv("QUICKED_TPU_STAGED_SHORT", "0")
    assert not cs._prefer_staged_short()
