"""Device selection, the compile cache and host<->device transfer helpers.

The reference's pinned-host-buffer + cudaMemcpy transfer path
(cuda/bench_utils.cu:101-155) maps to PJRT transfers:
``jax.device_put`` (host->device) and ``np.asarray`` on a device array
(device->host, synchronizing). Where the runtime supports the
``pinned_host`` memory kind we stage through it so the DMA source is
page-locked, the direct analog of cudaMallocHost.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

import jax
import numpy as np

# Fixed so that every process of a checkout finds the same cache (the
# directory is part of the cache key). Listed in .gitignore.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on XLA's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is set here. Otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu() -> str:
    """The platform of the default device; raises unless it is a GPU.

    The one exception is an explicit ``JAX_PLATFORMS=cpu`` rehearsal,
    whose records then name the CPU."""
    p = platform()
    if p == "gpu":
        return p
    if p == "cpu" and os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return p
    raise RuntimeError(
        f"no GPU found (JAX's default device is {p!r}); set "
        "JAX_PLATFORMS=cpu explicitly for a CPU rehearsal")


def card_info() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, from
    a child process that stays off JAX; None where there is no
    nvidia-smi (the CPU)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_record() -> Dict[str, Any]:
    """What every result names: platform, device kind and device count."""
    d = default_device()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@functools.lru_cache(maxsize=None)
def default_device():
    return jax.devices()[0]


@functools.lru_cache(maxsize=None)
def platform() -> str:
    return default_device().platform


@functools.lru_cache(maxsize=None)
def pinned_host_sharding() -> Optional[Any]:
    """SingleDeviceSharding with memory_kind='pinned_host' if supported."""
    try:
        s = jax.sharding.SingleDeviceSharding(
            default_device(), memory_kind="pinned_host"
        )
        # Probe support with a tiny transfer.
        probe = jax.device_put(np.zeros(8, np.float32), s)
        jax.block_until_ready(probe)
        return s
    except Exception:  # noqa: BLE001 - capability probe
        return None


def stage_pinned(host_array: np.ndarray):
    """Place a host array in page-locked (pinned_host) memory -- the
    cudaMallocHost analog (cuda/bench_utils.cu:101-155): the returned
    buffer is the DMA source for subsequent host->device transfers, so
    the per-block upload pays only the DMA leg, not a page-copy.
    Returns None where the runtime does not support the memory kind
    (callers fall back to pageable device_put and record which path
    ran)."""
    s = pinned_host_sharding()
    if s is None:
        return None
    try:
        staged = jax.device_put(host_array, s)
        jax.block_until_ready(staged)
        return staged
    except Exception:  # noqa: BLE001 - capability probe
        return None


@functools.lru_cache(maxsize=None)
def device_memory_sharding():
    """SingleDeviceSharding targeting the device's own memory ('device'
    kind) -- the explicit destination a pinned_host-resident source
    needs (a bare Device target raises a memory-kind mismatch)."""
    return jax.sharding.SingleDeviceSharding(
        default_device(), memory_kind="device"
    )


def to_device(host_array, device=None):
    """Host -> device transfer (cudaMemcpy H2D analog). `device` may also
    be a Sharding for multi-device placement. Pinned-host-staged
    sources (stage_pinned) route to the device-memory sharding."""
    if device is None:
        src_sharding = getattr(host_array, "sharding", None)
        if getattr(src_sharding, "memory_kind", None) == "pinned_host":
            return jax.device_put(host_array, device_memory_sharding())
        return jax.device_put(host_array, default_device())
    return jax.device_put(host_array, device)


@functools.lru_cache(maxsize=None)
def dp_sharding(n_devices: int):
    """NamedSharding partitioning the leading (track) axis over a
    1-D "dp" mesh of the first n_devices devices (the multi-device
    data-parallel extension; the reference is single-device)."""
    devices = jax.devices()[:n_devices]
    mesh = jax.sharding.Mesh(np.asarray(devices), ("dp",))
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))


def from_device(device_array) -> np.ndarray:
    """Device -> host transfer (cudaMemcpy D2H analog). np.asarray
    performs its own completion wait."""
    return np.asarray(device_array)


def block(tree) -> None:
    jax.block_until_ready(tree)
