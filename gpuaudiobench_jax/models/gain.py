"""gain: out = 2.0 * in per sample (cuda/bench_gain.cu)."""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.elementwise import gain_op
from gpuaudiobench_jax.utils import device as dev

GAIN_VALUE = 2.0  # benchmark_constants.cuh:6 (GAIN_VALUE)


class GainBenchmark(StandardBufferBenchmark):
    name = "gain"
    tolerance = 1e-5  # bench_gain.cu:78

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.golden = (np.float32(GAIN_VALUE) * self.host_input).astype(np.float32)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y = gain_op(x, GAIN_VALUE)
        self.host_output = dev.from_device(y)

    def device_iterate(self) -> None:
        dev.block(gain_op(self._resident_input, GAIN_VALUE))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(
            lambda x: gain_op(x, GAIN_VALUE), self._resident_input
        )

    def overlap_body(self):
        return (lambda x, c: (gain_op(x, GAIN_VALUE), c),
                self.overlap_blocks(), ())

    def cost_model(self):
        n = self.total_elements()
        return {"flops": n, "hbm_bytes": 2 * n * 4, "unit": "fp32"}
