"""GainStats: gain (x0.5) plus per-track [mean, max] statistics
(cuda/bench_gainstats.cu). The stats reduce the *input* samples
(bench_gainstats.cu:15-30); gain applies only to the output buffer.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.elementwise import gain_stats_op
from gpuaudiobench_jax.utils import device as dev

GAINSTATS_GAIN = 0.5  # benchmark_constants.cuh:7 (CUDA; Metal uses 2.0 --
# deliberate divergence resolved in favor of the CUDA golden, SURVEY.md s7)
NSTATS = 2


class GainStatsBenchmark(StandardBufferBenchmark):
    name = "GainStats"
    tolerance = 1e-5  # output, bench_gainstats.cu:88
    stats_tolerance = 1e-4  # stats buffer, bench_gainstats.cu:100

    def setup(self) -> None:
        self.setup_standard_buffers()
        x64 = self.host_input.astype(np.float64)
        self.golden = (np.float32(GAINSTATS_GAIN) * self.host_input).astype(np.float32)
        self.golden_stats = np.stack(
            [x64.mean(axis=1), x64.max(axis=1)], axis=1
        ).astype(np.float32)
        self.host_stats = None

        # Single-transfer readback: fuse output + stats into one flat array.
        import jax
        import jax.numpy as jnp

        def _step(x):
            y, stats = gain_stats_op(x, GAINSTATS_GAIN)
            return jnp.concatenate([y.ravel(), stats.ravel()])

        self._step = jax.jit(_step)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        buf = dev.from_device(self._step(x))
        n = self.total_elements()
        self.host_output = buf[:n].reshape(self.track_count, self.buffer_size)
        self.host_stats = buf[n:].reshape(self.track_count, NSTATS)

    def device_iterate(self) -> None:
        dev.block(gain_stats_op(self._resident_input, GAINSTATS_GAIN))

    def overlap_body(self):
        step = self._step
        return (lambda x, c: (step(x), c), self.overlap_blocks(), ())

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(
            lambda x: gain_stats_op(x, GAINSTATS_GAIN), self._resident_input
        )

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 3 * n,  # gain mul + mean-add + max-cmp per sample
            "hbm_bytes": (2 * n + 2 * self.track_count) * 4,
            "unit": "fp32",
        }

    def validate(self) -> ValidationData:
        v = compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} output",
        )
        v.merge_failure(
            compare_abs(
                self.host_stats, self.golden_stats, self.stats_tolerance,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} stats",
            )
        )
        return v

    def metadata(self):
        return {"gain": GAINSTATS_GAIN, "nStats": NSTATS}
