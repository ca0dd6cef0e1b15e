"""Test configuration.

By default the tests run JAX on the CPU with 8 virtual devices, so
sharding and interpret-mode kernel tests run anywhere. Tests marked
`gpu` need the card and skip elsewhere (the `gpu` fixture decides, at
run time): `python -m pytest tests -m gpu` on a machine with a GPU
leaves JAX on its default platform and runs them there (chip_smoke.py
does so before it opens the card itself)."""

import os

import pytest


def _card_run(config) -> bool:
    return config.getoption("markexpr", "") == "gpu"


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="run slow (large-input) parity tests")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow large-input parity tests")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; run with -m gpu where there is one")
    if not _card_run(config):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_sessionstart(session):
    import jax

    if not _card_run(session.config):
        jax.config.update("jax_platforms", "cpu")
        assert len(jax.devices()) >= 8, jax.devices()
    # scan-heavy kernels: cold compiles dominate test wall time
    from quicked_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="needs --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The card, or a skip where JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run `python -m pytest tests -m gpu` "
                    "on the card)")
    return dev
