"""Test config: CPU-only with 8 virtual devices (the simulated multi-host
mesh the reference cannot test without real MPI — SURVEY.md §4 takeaway),
and float64 enabled for oracle-grade accuracy.

The platform is forced through jax.config (still possible before the first
backend initialization), so the suite runs on the CPU wherever it is
started.  Tests marked `gpu` need an NVIDIA GPU and skip here; on the card
`python chip_smoke.py` runs the same checks in-process."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    return jax.devices()


@pytest.fixture
def gpu():
    """The GPU a `gpu`-marked test runs on; skips anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card these checks run "
                    "in-process through `python chip_smoke.py`")
    return dev


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running acceptance tests (still run in CI)")
    config.addinivalue_line(
        "markers", "gpu: real-width checks that need an NVIDIA GPU (skip "
                   "on the CPU; chip_smoke.py runs them on the card)")
