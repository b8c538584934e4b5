"""Benchmark base class: the analog of the reference's plugin API.

The reference's four override points (cuda/bench_base.cuh:94-97:
setupBenchmark / runKernel / performBenchmarkIteration / validate) map to:

* ``setup()``      -- allocate host buffers, generate seeded test data,
                      jit-compile the device program (the cuFFT-plan /
                      Metal-pipeline analog), compute the NumPy golden.
* ``iterate()``    -- ONE measured iteration: host->HBM transfer, jitted
                      device compute, HBM->host readback, fully
                      synchronized (jax.block_until_ready). This is the
                      hot path timed by the runner.
* ``device_iterate()`` -- optional device-only timing body run in a
                      separate pass on HBM-resident inputs (the
                      cudaEvent / MTLCommandBuffer-gpuTime analog).
* ``validate()``   -- compare last iteration's host output against the
                      golden with the benchmark's tolerance/metric.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.statistics import LatencyStats
from gpuaudiobench_jax.harness.validation import ValidationData


@dataclasses.dataclass
class BenchmarkResult:
    benchmark_name: str = ""
    buffer_size: int = 0
    track_count: int = 0
    iterations: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
    statistics: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    # Device-only latencies (separate timing pass on HBM-resident data).
    device_latencies: List[float] = dataclasses.field(default_factory=list)
    device_statistics: Optional[LatencyStats] = None
    # How device time was obtained: "trace" (the profiler's per-kernel
    # device time, the cudaEvent analog).
    device_timing_method: str = ""
    # Derived performance metrics (cuda/bench_base.cu:110-115).
    bytes_processed: int = 0
    mean_latency_ms: float = 0.0
    throughput_gbps: float = 0.0
    samples_per_sec: float = 0.0
    # Validation outcome + per-benchmark metadata (Metal-style).
    validation: Optional[ValidationData] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # DAW-sim deadline tracking (Statistics.swift:172-192).
    deadline_miss_rate: Optional[float] = None
    # Saturated/streaming pass (--pipelineDepth): marginal ms/block with
    # the dispatch pipeline kept full (N blocks per executable).
    pipeline_depth: int = 0
    saturated_latencies: List[float] = dataclasses.field(default_factory=list)
    saturated_statistics: Optional[LatencyStats] = None
    # Saturated MARGINAL tier (streaming.measure_saturated_marginal):
    # depth-differenced per-block cost with the fixed dispatch+readback
    # cost cancelled. saturated_latencies above is the amortized
    # wall/depth (includes that fixed cost / depth).
    saturated_lo_depth: int = 0
    saturated_marginal_latencies: List[float] = dataclasses.field(
        default_factory=list)
    saturated_marginal_statistics: Optional[LatencyStats] = None
    # Overlapped-infeed pass (--overlapDepth): per-block ms with the
    # input upload double-buffered against compute, plus the serial
    # twin measured in the same reps (harness/overlap.py).
    overlap_depth: int = 0
    overlap_serial_latencies: List[float] = dataclasses.field(
        default_factory=list)
    overlap_latencies: List[float] = dataclasses.field(default_factory=list)
    overlap_serial_statistics: Optional[LatencyStats] = None
    overlap_statistics: Optional[LatencyStats] = None


class Benchmark:
    """Base class for all benchmark workloads."""

    name: str = "Benchmark"

    def __init__(self, cfg: BenchConfig):
        self.cfg = cfg
        self.buffer_size = cfg.buffer_size
        self.track_count = cfg.n_tracks
        self._allocations: Dict[str, int] = {}
        self._sharding = None
        # Set by setup_sharding(); the runner refuses to run a benchmark
        # under --dataParallel that never declared its sharded axis, so
        # the flag can never silently no-op.
        self._dp_ready = False

    # -- data-parallel sharding (--dataParallel: SPMD over a "dp" mesh) ----
    def setup_sharding(self, axis_size: int, axis_label: str = "nTracks") -> None:
        """Declare the benchmark's data-parallel axis; call from setup()
        with the size of the axis that shards over the dp mesh."""
        self._dp_ready = True
        self._sharding = None
        if self.cfg.data_parallel > 1:
            if axis_size % self.cfg.data_parallel != 0:
                raise ValueError(
                    f"{axis_label} ({axis_size}) must be divisible by "
                    f"--dataParallel ({self.cfg.data_parallel})"
                )
            from gpuaudiobench_jax.utils import device as dev

            self._sharding = dev.dp_sharding(self.cfg.data_parallel)

    def reject_data_parallel(self, reason: str) -> None:
        """Benchmarks with no shardable dp axis call this from setup():
        under --dataParallel it raises ``reason`` (their own targeted
        message); otherwise it records that the flag was consciously
        rejected so the runner's generic no-axis-declared error never
        fires for them."""
        if self.cfg.data_parallel > 1:
            raise ValueError(reason)
        self._dp_ready = True

    def put_sharded(self, host_array):
        """H2D placement, leading axis sharded over the dp mesh when
        --dataParallel > 1 (XLA SPMD partitions the jitted programs)."""
        from gpuaudiobench_jax.utils import device as dev

        return dev.to_device(host_array, self._sharding)

    def put_replicated(self, a):
        """Auxiliary arrays must live on the same mesh as sharded inputs."""
        from gpuaudiobench_jax.utils import device as dev

        if self._sharding is None:
            return dev.to_device(a)
        import jax

        rep = jax.sharding.NamedSharding(
            self._sharding.mesh, jax.sharding.PartitionSpec()
        )
        return jax.device_put(a, rep)

    def put_spec(self, a, *axes):
        """Place with an explicit PartitionSpec on the dp mesh ("dp" or
        None per axis); plain device placement when unsharded."""
        from gpuaudiobench_jax.utils import device as dev

        if self._sharding is None:
            return dev.to_device(a)
        import jax

        s = jax.sharding.NamedSharding(
            self._sharding.mesh, jax.sharding.PartitionSpec(*axes)
        )
        return jax.device_put(a, s)

    # -- allocation tracking (BufferManager.totalMemoryAllocated analog,
    # metal-swift/.../BenchmarkUtilities.swift:30-77) ---------------------
    def track_alloc(self, name: str, nbytes: int) -> None:
        self._allocations[name] = int(nbytes)

    def memory_report(self) -> Dict[str, int]:
        if not self._allocations:
            return {}
        report = dict(self._allocations)
        report["totalBytes"] = sum(self._allocations.values())
        return report

    # -- lifecycle ---------------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def iterate(self) -> None:
        raise NotImplementedError

    def device_iterate(self) -> None:
        """Device-only compute on resident buffers; None = unsupported."""
        raise NotImplementedError

    def supports_device_timing(self) -> bool:
        return True

    def stream_body(self):
        """Optional streaming-mode hook (--pipelineDepth): return
        ``(step_fn, carry)`` where ``step_fn(carry) -> (carry', probe)``
        runs ONE block on device-resident data, carrying state where the
        benchmark has it. The harness jits a lax.scan of N steps and
        times the chained executable (harness/streaming.py). Stateless
        blocks should use ``streaming.barrier_chain`` so XLA cannot
        hoist the loop-invariant body. None = unsupported (e.g.
        datacopy*, whose entire point is the host<->device round trip).
        """
        return None

    def overlap_body(self):
        """Optional overlapped-infeed hook (--overlapDepth): return
        ``(step_fn, host_blocks, carry)`` where ``step_fn(x_dev, carry)
        -> (y, carry')`` runs ONE block of device compute on an
        uploaded input block (jitted), ``host_blocks`` is a list of
        >= 2 distinct host payload arrays cycled across blocks, and
        ``carry`` is the initial device-resident state pytree (() for
        stateless blocks). The harness measures serial vs
        double-buffered steady state (harness/overlap.py). None =
        unsupported (e.g. modal synthesis, which uploads nothing per
        block)."""
        return None

    def validate(self) -> ValidationData:
        raise NotImplementedError

    def metadata(self) -> Dict[str, Any]:
        return {}

    def cost_model(self):
        """Algorithmic per-block cost for roofline accounting
        (utils/roofline.py): {"flops", "hbm_bytes", "unit"} or None.
        flops = required arithmetic; hbm_bytes = minimum device-memory
        traffic assuming perfect on-chip reuse (inputs + outputs +
        state); unit = the peak it is judged against (roofline.UNITS)."""
        return None

    def cleanup(self) -> None:
        pass

    # -- metrics helpers ---------------------------------------------------
    def total_elements(self) -> int:
        return self.buffer_size * self.track_count

    def bytes_processed(self) -> int:
        """Bytes counted for throughput (bench_base.cu:110-111)."""
        return self.total_elements() * 4
