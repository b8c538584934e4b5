"""Shared benchmark scaffolding: standard (tracks x bufferSize) buffer
lifecycle (the BufferSet analog, cuda/bench_base.cuh:50-74)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.utils.data import generate_random_audio
from gpuaudiobench_jax.utils import device as dev


class StandardBufferBenchmark(Benchmark):
    """Benchmark over the standard track-major (tracks, bufferSize) float32
    in/out pair with seeded +-1 uniform test data (bench_base.cu:9-49)."""

    tolerance: float = 1e-5

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)
        self.host_input: Optional[np.ndarray] = None
        self.host_output: Optional[np.ndarray] = None
        self.golden: Optional[np.ndarray] = None
        self._resident_input = None

    def make_input(self) -> np.ndarray:
        data = generate_random_audio(self.total_elements(), self.cfg.seed)
        return data.reshape(self.track_count, self.buffer_size)

    def put_input(self, host_array: np.ndarray):
        """H2D placement, track axis dp-sharded (Benchmark.put_sharded)."""
        return self.put_sharded(host_array)

    def setup_standard_buffers(self) -> None:
        self.setup_sharding(self.track_count)
        self.host_input = self.make_input()
        self._resident_input = self.put_input(self.host_input)
        nbytes = self.host_input.nbytes
        self.track_alloc("hostInput", nbytes)
        self.track_alloc("hostOutput", nbytes)
        self.track_alloc("deviceInput", nbytes)
        self.track_alloc("deviceOutput", nbytes)

    def overlap_blocks(self):
        """Two distinct host payloads for the overlapped-infeed tier
        (harness/overlap.py): same shape/dtype, different content, so
        every per-block upload is a real transfer rather than a
        runtime-dedupable repeat."""
        a = self.host_input
        return [a, np.negative(a)]

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output,
            self.golden,
            self.tolerance,
            mode=self.cfg.verification,
            limit=self.cfg.spot_sample_limit,
            label=self.name,
        )
