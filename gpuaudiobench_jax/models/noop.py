"""NoOp: dispatch-overhead benchmark (cuda/bench_noop.cu).

Measures the cost of one full host->HBM->program->host round trip with a
minimal validatable copy program (bench_noop.cu:9-16); this is
dominated by PJRT dispatch + transfer latency, the analog of
kernel-launch overhead in fig4 of the paper.
"""

from __future__ import annotations

from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.elementwise import copy_op
from gpuaudiobench_jax.utils import device as dev


class NoOpBenchmark(StandardBufferBenchmark):
    name = "NoOp"
    tolerance = 1e-5  # bench_noop.cu:838

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.golden = self.host_input.copy()  # out == in (bench_noop.cu:849-856)
        self.iterate()  # warm jit compile (plan-creation analog)

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y = copy_op(x)
        self.host_output = dev.from_device(y)

    def device_iterate(self) -> None:
        dev.block(copy_op(self._resident_input))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(copy_op, self._resident_input)

    def cost_model(self):
        n = self.total_elements()
        return {"flops": 0, "hbm_bytes": 2 * n * 4, "unit": "fp32",
                "note": "copy in+out"}
