"""Iteration driver: warmup -> timed loop -> statistics -> validation.

Port of GPUABenchmark::runWithIteration (cuda/bench_base.cu:59-118) with
Metal's extensions (DAW-sim pacing between iterations, verification
modes). Timing is wall-clock around one fully synchronized
host->HBM->kernel->host round trip, the same measurement boundary as the
reference's BenchmarkTimer::measureKernel around
transferToDevice/launch/sync/transferToHost.

Warmup additionally absorbs XLA jit compilation -- the analog of
cuFFT plan creation / Metal pipeline compilation, which the reference
also performs before the timed loop.
"""

from __future__ import annotations

import time
from typing import Optional

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark, BenchmarkResult
from gpuaudiobench_jax.harness.dawsim import deadline_miss_rate
from gpuaudiobench_jax.harness.statistics import calculate_statistics


def run_benchmark(
    benchmark: Benchmark,
    cfg: Optional[BenchConfig] = None,
    verbose: bool = True,
    progress_cb=None,
) -> BenchmarkResult:
    """``progress_cb``, when given, is called with a phase string at
    each stage boundary ("warmup", "timed", "device-timing",
    "saturated", "validate") -- the interactive UI surfaces it so a
    long stage reads as progress, not a hang."""
    cfg = cfg or benchmark.cfg

    def phase(name: str) -> None:
        if progress_cb is not None:
            try:
                progress_cb(name)
            except Exception:  # noqa: BLE001 - progress is best-effort
                pass

    if cfg.data_parallel > 1 and not benchmark._dp_ready:
        raise ValueError(
            f"{benchmark.name} does not support --dataParallel "
            "(no sharded axis declared in setup)"
        )
    result = BenchmarkResult(
        benchmark_name=benchmark.name,
        buffer_size=benchmark.buffer_size,
        track_count=benchmark.track_count,
        iterations=cfg.n_runs,
    )

    daw = None
    if cfg.dawsim:
        from gpuaudiobench_jax.utils.native import make_dawsim

        daw = make_dawsim(
            cfg.buffer_size, cfg.fs, cfg.dawsim_mode, cfg.dawsim_jitter_us, cfg.seed
        )

    import contextlib

    from gpuaudiobench_jax.harness.profiler import capture_trace

    capture = (
        capture_trace(cfg.capture_dir) if cfg.capture else contextlib.nullcontext()
    )
    with capture:
        # Warmup (bench_base.cu:70-81); iteration 1 also pays jit compile.
        if cfg.warmup > 0:
            phase("warmup")
            if verbose:
                print(f"Running {cfg.warmup} warmup iterations...")
            for i in range(cfg.warmup):
                try:
                    benchmark.iterate()
                except Exception as e:  # noqa: BLE001 - mirror reference tolerance
                    if verbose:
                        print(f"  Warmup iteration {i + 1} failed: {e}")
            if verbose:
                print("Warmup complete, starting timed iterations...")

        # Timed iterations (bench_base.cu:89-94).
        phase("timed")
        latencies = []
        if daw is not None:
            daw.reset()
        for _ in range(cfg.n_runs):
            if daw is not None:
                daw.wait()
            t0 = time.perf_counter()
            benchmark.iterate()
            t1 = time.perf_counter()
            latencies.append((t1 - t0) * 1000.0)

        result.latencies = latencies
        result.statistics = calculate_statistics(latencies)

        # Device-only timing pass (the cudaEvent / gpuStartTime analog):
        # on-device execution time from the profiler trace
        # (harness/device_timing.py).
        if cfg.device_timing and benchmark.supports_device_timing():
            phase("device-timing")
            from gpuaudiobench_jax.harness.device_timing import (
                measure_device_times,
            )

            dev_latencies, method = measure_device_times(benchmark, cfg)
            if dev_latencies:
                result.device_latencies = dev_latencies
                result.device_statistics = calculate_statistics(dev_latencies)
                result.device_timing_method = method

        # Saturated/streaming pass: marginal per-block cost with the
        # dispatch pipeline kept full (--pipelineDepth blocks per
        # executable, state carried).
        if cfg.pipeline_depth > 1:
            body = benchmark.stream_body()
            if body is None:
                if verbose:
                    print(
                        f"Note: {benchmark.name} has no streaming mode "
                        "(round-trip is the workload); skipping saturated pass."
                    )
            else:
                phase("saturated")
                step_fn, carry = body
                result.pipeline_depth = cfg.pipeline_depth
                if cfg.saturated_marginal and cfg.pipeline_depth >= 4:
                    from gpuaudiobench_jax.harness.streaming import (
                        measure_saturated_marginal,
                    )

                    sat, marg, lo = measure_saturated_marginal(
                        step_fn, carry, cfg.pipeline_depth,
                        cfg.saturated_reps,
                    )
                    result.saturated_lo_depth = lo
                    result.saturated_marginal_latencies = marg
                    result.saturated_marginal_statistics = (
                        calculate_statistics(marg)
                    )
                else:
                    from gpuaudiobench_jax.harness.streaming import (
                        measure_saturated,
                    )

                    sat = measure_saturated(
                        step_fn, carry, cfg.pipeline_depth,
                        cfg.saturated_reps,
                    )
                result.saturated_latencies = sat
                result.saturated_statistics = calculate_statistics(sat)

        # Overlapped-infeed pass: double-buffer the input upload
        # against compute (SURVEY §2.4 PP axis; harness/overlap.py)
        # and measure the serial twin in the same reps.
        if cfg.overlap_depth > 1 and cfg.data_parallel > 1:
            if verbose:
                print("Note: overlapped-infeed pass is single-device "
                      "(uploads target one chip's HBM); skipping under "
                      "--dataParallel.")
        elif cfg.overlap_depth > 1:
            ob = benchmark.overlap_body()
            if ob is None:
                if verbose:
                    print(
                        f"Note: {benchmark.name} has no per-block input "
                        "upload; skipping overlapped-infeed pass."
                    )
            else:
                phase("overlap")
                from gpuaudiobench_jax.harness.overlap import measure_overlap

                step_fn, host_blocks, ocarry = ob
                ser, ovl = measure_overlap(
                    step_fn, host_blocks, ocarry,
                    cfg.overlap_depth, cfg.overlap_reps,
                )
                result.overlap_depth = cfg.overlap_depth
                result.overlap_serial_latencies = ser
                result.overlap_latencies = ovl
                result.overlap_serial_statistics = calculate_statistics(ser)
                result.overlap_statistics = calculate_statistics(ovl)

        # Derived metrics (bench_base.cu:110-115).
        result.bytes_processed = benchmark.bytes_processed()
        result.mean_latency_ms = result.statistics.mean
        if result.mean_latency_ms > 0:
            mean_sec = result.mean_latency_ms / 1000.0
            result.throughput_gbps = (result.bytes_processed / (1024.0**3)) / mean_sec
            result.samples_per_sec = benchmark.total_elements() / mean_sec

        if cfg.dawsim:
            result.deadline_miss_rate = deadline_miss_rate(
                latencies, cfg.buffer_size, cfg.fs
            )

        phase("validate")
        result.validation = benchmark.validate()
        result.metadata = benchmark.metadata()

        # Roofline accounting: algorithmic cost over measured on-device
        # block time (utils/roofline.py), against the published peaks of
        # the card that ran it. Prefers the device time (trace); falls
        # back to the saturated per-block time when the device pass is
        # off. The CPU has no peak table, so it gets no roofline.
        from gpuaudiobench_jax.utils import device as dev
        from gpuaudiobench_jax.utils.roofline import roofline_metrics

        cost = benchmark.cost_model()
        if cost is not None and dev.platform() == "gpu":
            candidates = []
            if result.device_statistics is not None:
                candidates.append((result.device_statistics.median,
                                   f"device:{result.device_timing_method}"))
            if result.saturated_marginal_statistics is not None:
                candidates.append((
                    result.saturated_marginal_statistics.median,
                    "saturated-marginal",
                ))
            if result.saturated_statistics is not None:
                candidates.append(
                    (result.saturated_statistics.median, "saturated")
                )
            # Bodies below timer resolution (marginal <= 0) fall
            # through to the next basis.
            block_ms, basis = next(
                ((ms, b) for ms, b in candidates if ms > 0), (0.0, "")
            )
            if block_ms > 0:
                rl = roofline_metrics(cost, block_ms,
                                      dev.default_device().device_kind)
                rl["basis"] = basis
                result.metadata["roofline"] = rl
        mem = benchmark.memory_report()
        if mem:
            result.metadata["memory"] = mem

    return result
