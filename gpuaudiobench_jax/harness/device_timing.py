"""Device-side timing: the CudaEventTimer / MTLCommandBuffer-gpuTime
analog (cuda/bench_utils.cu:28-95, GPUABenchmark.swift:483-497).

The device body runs under a ``jax.profiler`` trace, and the GPU's own
record of each kernel is read back from the trace's device plane. On a
GPU the plane is ``/device:GPU:<n>`` and its lines are CUDA streams
("Stream #13(Compute)"); each event is one kernel or copy with its
device start and duration. A run's device time is the sum of the
durations of the events it launched (its busy time on the card).

There is no fallback: a GPU trace that cannot be read raises, because
a wall-clock number in its place would be a host measurement under a
device metric's name. On the CPU there is no device plane and no device
time; the pass reports "not measured".
"""

from __future__ import annotations

import glob
import shutil
import tempfile
from typing import Callable, List, Optional, Tuple


def device_plane_events(path: str) -> List[List[float]]:
    """Durations (ms) of the events on each GPU device plane of the
    xplane trace at ``path``, in device start order, one list per plane.

    Kept per-plane because under ``--dataParallel N`` the N devices each
    run the same SPMD program CONCURRENTLY: flattening planes together
    would sum parallel executions as if sequential.
    """
    import jax

    with open(path, "rb") as f:
        pd = jax.profiler.ProfileData.from_serialized_xspace(f.read())
    planes: List[List[float]] = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        events = [(ev.start_ns, ev.duration_ns)
                  for line in plane.lines
                  if (line.name or "").startswith("Stream")
                  for ev in line.events]
        if events:
            planes.append([d / 1e6 for _, d in sorted(events)])
    return planes


def per_run_times(planes: List[List[float]], n_runs: int) -> List[float]:
    """Split each plane's events into ``n_runs`` equal groups (one
    executable launches the same kernels every run) and sum each group;
    across planes a run's time is the MAX (concurrent SPMD replicas).
    Raises when the events do not split evenly into runs."""
    if not planes:
        raise RuntimeError("the trace has no GPU device events")
    runs = []
    for durations in planes:
        if len(durations) % n_runs:
            raise RuntimeError(
                f"{len(durations)} device events do not split into "
                f"{n_runs} runs")
        k = len(durations) // n_runs
        runs.append([sum(durations[i * k:(i + 1) * k])
                     for i in range(n_runs)])
    return [max(r[i] for r in runs) for i in range(n_runs)]


def trace_device_times(body: Callable[[], None], n_runs: int) -> List[float]:
    """Per-run device execution times (ms) of ``body`` from a
    jax.profiler trace of ``n_runs`` runs (one warm run first)."""
    import jax

    trace_dir = tempfile.mkdtemp(prefix="audiobench_devtime_")
    try:
        body()  # warm outside the trace
        jax.profiler.start_trace(trace_dir)
        try:
            for _ in range(n_runs):
                body()
        finally:
            jax.profiler.stop_trace()
        files = sorted(glob.glob(trace_dir + "/**/*.xplane.pb",
                                 recursive=True))
        if not files:
            raise RuntimeError("the profiler wrote no trace")
        return per_run_times(device_plane_events(files[-1]), n_runs)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def measure_device_times(benchmark, cfg) -> Tuple[Optional[List[float]], str]:
    """(latencies_ms, method): the trace on a GPU, ``(None, "not
    measured")`` elsewhere."""
    from gpuaudiobench_jax.utils import device as dev

    if dev.platform() != "gpu":
        return None, "not measured"
    n = min(cfg.n_runs, 20)  # trace size guard
    return trace_device_times(benchmark.device_iterate, n), "trace"
