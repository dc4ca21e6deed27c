"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes.  Device behavior is exercised
by the opt-in on-device lane (tests/test_device_parity.py, marker
``device``), run on a machine with a GPU:

    NAUTILUS_DEVICE_TESTS=1 python -m pytest tests -m device -q

Without NAUTILUS_DEVICE_TESTS the whole suite is forced onto CPU and the
device-marked tests skip.
"""

import os

_DEVICE_LANE = os.environ.get("NAUTILUS_DEVICE_TESTS") == "1"

if not _DEVICE_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _DEVICE_LANE:
    # The env var is only read when jax is first imported; force CPU via
    # the config too in case a plugin imported jax before this file.
    jax.config.update("jax_platforms", "cpu")
    # No persistent compile cache for the CPU suite: XLA:CPU cache entries
    # embed AOT machine code, and deserializing a stale/foreign-host
    # artifact SIGSEGVs the whole run (crash stack:
    # compilation_cache.get_executable_and_time).  Each worker's in-memory
    # cache already dedups compiles within the run; the persistent cache
    # only saved cross-run compile time, which is not worth a segfault
    # class of flake.
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "device: on-device parity lane (needs NAUTILUS_DEVICE_TESTS=1 and "
        "a GPU)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
