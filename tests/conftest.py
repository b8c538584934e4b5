"""Test environment: force the CPU backend with 8 virtual devices so the
full suite (including multi-device sharding tests) runs hardware-free.
Must run before any jax import.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture. They run where ``AUDIOBENCH_GPU_TESTS=1`` leaves
the platform alone (``chip_smoke.py`` runs them in its own process on
the card); everywhere else they skip.
"""

import os

GPU_TESTS = os.environ.get("AUDIOBENCH_GPU_TESTS") == "1"

if not GPU_TESTS:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not GPU_TESTS:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gpuaudiobench_jax.config import BenchConfig  # noqa: E402


@pytest.fixture
def small_cfg():
    """Scaled-down config for fast end-to-end tests."""
    return BenchConfig(
        buffer_size=64,
        n_tracks=8,
        n_runs=3,
        warmup=1,
        rndmem_pool_mb=8,
        write_latencies=False,
        device_timing=False,
        sol_fma_k=16,
        sol_fma_mib=1,
        sol_stream_mib=1,
        sol_matmul_dim=128,
    )


@pytest.fixture
def gpu_device():
    """The default device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while a module is imported."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {d.platform}); run "
                    "on the card through chip_smoke.py")
    return d


@pytest.fixture
def rng():
    return np.random.Generator(np.random.MT19937(123))
