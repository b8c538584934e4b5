"""ctypes bindings to the native harness core (native/gpuab_native.cc).

The reference's statistics/timing/DAW-sim code is native C++/Swift;
this loads the suite's equivalent shared library when present
(native/build/libgpuab_native.so) and exposes it to the Python harness.
Pure-Python fallbacks live in harness/statistics.py and harness/dawsim.py;
call sites prefer the native path via `available()`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build",
                 "libgpuab_native.so"),
    os.environ.get("GPUAB_NATIVE_LIB", ""),
]


class _GpuabStats(ctypes.Structure):
    _fields_ = [
        ("mean", ctypes.c_double),
        ("median", ctypes.c_double),
        ("std_dev", ctypes.c_double),
        ("min_val", ctypes.c_double),
        ("max_val", ctypes.c_double),
        ("p95", ctypes.c_double),
        ("p99", ctypes.c_double),
        ("count", ctypes.c_int64),
    ]


_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    for path in _LIB_PATHS:
        if not path:
            continue
        path = os.path.abspath(path)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.gpuab_calculate_statistics.restype = ctypes.c_int
            lib.gpuab_calculate_statistics.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(_GpuabStats),
            ]
            lib.gpuab_csv_percentile.restype = ctypes.c_double
            lib.gpuab_csv_percentile.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_double,
            ]
            lib.gpuab_monotonic_ns.restype = ctypes.c_int64
            lib.gpuab_dawsim_create.restype = ctypes.c_void_p
            lib.gpuab_dawsim_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_uint32,
            ]
            lib.gpuab_dawsim_destroy.argtypes = [ctypes.c_void_p]
            lib.gpuab_dawsim_reset.argtypes = [ctypes.c_void_p]
            lib.gpuab_dawsim_wait.argtypes = [ctypes.c_void_p]
            _lib = lib
            return _lib
    return None


def available() -> bool:
    return _load() is not None


def reset() -> None:
    """Forget an earlier lookup, so a library built since is found."""
    global _lib, _load_attempted
    _lib, _load_attempted = None, False


def calculate_statistics_native(latencies: Sequence[float]):
    """Returns a harness LatencyStats computed by the native library,
    or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    from gpuaudiobench_jax.harness.statistics import LatencyStats

    n = len(latencies)
    arr = (ctypes.c_double * n)(*latencies)
    out = _GpuabStats()
    rc = lib.gpuab_calculate_statistics(arr, n, ctypes.byref(out))
    if rc != 0:
        return None
    return LatencyStats(
        mean=out.mean, median=out.median, std_dev=out.std_dev,
        min_val=out.min_val, max_val=out.max_val,
        p95=out.p95, p99=out.p99, count=int(out.count),
    )


class NativeDAWSimulator:
    """Native spin/sleep pacing (drop-in for harness.dawsim.DAWSimulator)."""

    def __init__(self, buffer_size: int, fs: int, mode: str = "spin",
                 jitter_us: float = 0.0, seed: int = 42):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.gpuab_dawsim_create(
            buffer_size, fs, 1 if mode == "sleep" else 0,
            float(jitter_us), seed & 0xFFFFFFFF,
        )

    def reset(self) -> None:
        self._lib.gpuab_dawsim_reset(self._handle)

    def wait(self) -> None:
        self._lib.gpuab_dawsim_wait(self._handle)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.gpuab_dawsim_destroy(handle)
            self._handle = None


def make_dawsim(buffer_size: int, fs: int, mode: str, jitter_us: float,
                seed: int):
    """Native DAW simulator when available, else the Python fallback."""
    if available():
        try:
            return NativeDAWSimulator(buffer_size, fs, mode, jitter_us, seed)
        except RuntimeError:
            pass
    from gpuaudiobench_jax.harness.dawsim import DAWSimulator

    return DAWSimulator(buffer_size, fs, mode, jitter_us, seed)


def self_test() -> None:
    assert available(), "libgpuab_native.so not found/loadable"
    from gpuaudiobench_jax.harness.statistics import calculate_statistics

    vals = [3.0, 1.0, 2.0, 5.0, 4.0]
    py = calculate_statistics(vals)
    nat = calculate_statistics_native(vals)
    for field in ("mean", "median", "std_dev", "min_val", "max_val", "p95", "p99"):
        a, b = getattr(py, field), getattr(nat, field)
        assert abs(a - b) < 1e-12, (field, a, b)
    sim = NativeDAWSimulator(64, 48000, "sleep")
    sim.wait()
    sim.wait()
    print("native self-test OK")
