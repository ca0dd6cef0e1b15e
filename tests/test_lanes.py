"""The lane table (aligner/lanes.py) and where caches land
(utils/cache.py)."""

import os
import subprocess
import sys

import pytest

from quicked_tpu import generate
from quicked_tpu.aligner import batch as ab
from quicked_tpu.aligner import lanes
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_table_entries():
    cpu, gpu = lanes.for_platform("cpu"), lanes.for_platform("gpu")
    assert cpu.host_first and cpu.score_kernel == "xla"
    assert not gpu.host_first and gpu.score_kernel == "triton"
    assert lanes.current() is cpu           # the tests run on the CPU


@pytest.mark.parametrize("name", ["rocm", "METAL", ""])
def test_unknown_platform_raises(name):
    with pytest.raises(lanes.UnsupportedPlatform):
        lanes.for_platform(name)


def _batch(length, pct, n=2):
    pairs = list(generate.generate_pairs(n, length, error=0.1, seed=61))
    return prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                                [max(len(p), len(t)) * pct // 100
                                 for p, t in pairs], full=False)


def _route(monkeypatch, table, batch, host_faster):
    """The venue _run_banded_auto picks under `table`, with the device
    kernels replaced by markers."""
    from quicked_tpu.ops import banded_cscan_jax, banded_triton

    monkeypatch.setattr(lanes, "current", lambda: table)
    monkeypatch.setattr(ab, "_prefer_host_deep", lambda b: host_faster)
    monkeypatch.setattr(ab, "_prefer_host_shallow",
                        lambda b, n: host_faster)
    monkeypatch.setattr(ab, "_device_with_cold_deferral",
                        lambda fam, b, run: fam)
    monkeypatch.setattr(banded_triton, "run_banded_triton",
                        lambda b: "triton")
    monkeypatch.setattr(banded_cscan_jax, "run_banded_cscan",
                        lambda b: "cscan_xla")
    out = ab._run_banded_auto(batch)
    return out if isinstance(out, str) else "host_c"


def test_gpu_lanes_by_band_depth(monkeypatch):
    """GPU: shallow bands -> the Triton kernel, deep bands -> the XLA
    carry-scan (each unless host C is estimated faster); a deep band
    never reaches the shallow kernel."""
    gpu = lanes.for_platform("gpu")
    shallow, deep = _batch(1000, 15), _batch(20_000, 50)
    assert not lanes.is_deep(shallow.EBB) and lanes.is_deep(deep.EBB)
    assert _route(monkeypatch, gpu, shallow, False) == "triton"
    assert _route(monkeypatch, gpu, deep, False) == "cscan_xla"
    assert _route(monkeypatch, gpu, shallow, True) == "host_c"
    assert _route(monkeypatch, gpu, deep, True) == "host_c"


def test_cpu_lanes_host_first(monkeypatch):
    """CPU: every score batch goes to host C, deep or not, with no cost
    model consulted; no device full-fill lane."""
    cpu = lanes.for_platform("cpu")
    for b in (_batch(1000, 15), _batch(20_000, 50)):
        assert _route(monkeypatch, cpu, b, False) == "host_c"
    assert ab._device_full_lane() is False


def test_compile_cache_env_verbatim(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that exact directory, and nothing
    set in code."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: one fixed path inside the checkout, the same every call."""
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.compile_cache_dir() == want
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    monkeypatch.delenv("QUICKED_TPU_CACHE", raising=False)
    assert cache.state_dir() == os.path.join(REPO, ".quicked_cache")


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when JAX
    finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    lines = r.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
