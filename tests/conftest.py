"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding (parallel/) is testable without GPUs
(SURVEY.md §6/§9: distributed tests via xla_force_host_platform_device_count).

Must set env BEFORE jax is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (x64 subprocess oracles etc.)"
    )


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite accumulates several hundred live XLA:CPU executables;
    past a capacity threshold the CPU client segfaults on a later compile
    (reproduced deterministically: tests/ crashed in test_wide_path.py
    only when the whole suite preceded it). Per-module cache clearing keeps the live-executable population
    bounded; within-module reuse (the expensive case) is preserved."""
    yield
    jax.clear_caches()
