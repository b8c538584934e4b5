"""Device-timing subsystem: the reduction from a profiler trace to
per-run device times, its refusal to guess, and runner integration. On
the CPU test backend a trace has no GPU device plane; the reduction is
covered on a GPU trace recorded on an H100 (tests/data), and on the
card itself by the ``gpu`` tests."""

import glob
import os
import tempfile

import numpy as np
import pytest

from gpuaudiobench_jax.harness.device_timing import (
    device_plane_events,
    measure_device_times,
    per_run_times,
    trace_device_times,
)
from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import create_benchmark

GPU_TRACE = os.path.join(os.path.dirname(__file__), "data",
                         "gpu_trace.xplane.pb")


def test_trace_has_no_device_plane_on_cpu(small_cfg):
    b = create_benchmark("gain", small_cfg)
    b.setup()
    with pytest.raises(RuntimeError, match="no GPU device events"):
        trace_device_times(b.device_iterate, 3)


def test_device_plane_events_reads_real_trace():
    """The xplane walker parses an actual CPU trace file: the proto
    loads and iterates, and it holds no GPU plane."""
    import jax
    import jax.numpy as jnp

    d = tempfile.mkdtemp()
    f = jax.jit(lambda a: a * 2.0)
    x = jnp.ones((8, 8), jnp.float32)
    _ = np.asarray(f(x))
    jax.profiler.start_trace(d)
    _ = np.asarray(f(x))
    jax.profiler.stop_trace()
    files = glob.glob(d + "/**/*.xplane.pb", recursive=True)
    assert files
    assert device_plane_events(files[-1]) == []


def test_recorded_gpu_trace_reduces_to_runs():
    """A trace of three runs of one jitted step, recorded on an H100:
    its one GPU plane holds the kernels of the stream lines, and they
    split into three equal runs of positive device time."""
    planes = device_plane_events(GPU_TRACE)
    assert len(planes) == 1 and len(planes[0]) % 3 == 0
    runs = per_run_times(planes, 3)
    assert len(runs) == 3 and all(0 < r < 1.0 for r in runs)


@pytest.mark.parametrize("planes,n,expect", [
    ([[1.0, 2.0, 3.0, 4.0]], 2, [3.0, 7.0]),
    ([[1.0, 1.0], [2.0, 0.5]], 2, [2.0, 1.0]),  # SPMD planes: max
    ([[0.25] * 6], 3, [0.5, 0.5, 0.5]),
])
def test_per_run_times_groups_and_maxes(planes, n, expect):
    assert per_run_times(planes, n) == pytest.approx(expect)


@pytest.mark.parametrize("planes,n", [([[1.0, 2.0, 3.0]], 2), ([], 2)])
def test_per_run_times_refuses_to_guess(planes, n):
    with pytest.raises(RuntimeError):
        per_run_times(planes, n)


def test_measure_device_times_methods(small_cfg):
    b = create_benchmark("gain", small_cfg)
    b.setup()
    assert measure_device_times(b, small_cfg) == (None, "not measured")


def test_runner_records_method(small_cfg):
    """On the CPU the device pass measures nothing, so no device
    statistics and no roofline appear under a device metric's name."""
    cfg = small_cfg.replace(device_timing=True)
    b = create_benchmark("gain", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    assert result.device_statistics is None
    assert result.device_timing_method == ""
    assert "roofline" not in result.metadata

    from gpuaudiobench_jax.harness.output import generate_json_results

    out = generate_json_results(result, cfg)
    assert "device_statistics" not in out
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}


@pytest.mark.gpu
def test_trace_device_times_on_the_card(gpu_device, small_cfg):
    cfg = small_cfg.replace(device_timing=True)
    b = create_benchmark("gain", cfg)
    b.setup()
    times, method = measure_device_times(b, cfg)
    assert method == "trace"
    assert len(times) == cfg.n_runs and all(t > 0 for t in times)
