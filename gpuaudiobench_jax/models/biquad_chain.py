"""BiquadChain: serial chain of N biquads per track (extension).

Port of the reference's unregistered Metal extra
(metal-swift/.../Metal/kernels_extra.metal:16-67: BenchmarkFilters_Biquad_N,
a chain of N<=10 biquads per thread, "results not used in paper").
Registered here as an extension benchmark: a 10-stage cascade of
Butterworth lowpass biquads with staggered cutoffs -- the classic
channel-strip EQ workload, and the sequential-depth stress test the
single-biquad IIRFilter doesn't cover (10x the recurrence depth).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.models.iir import iir_reference
from gpuaudiobench_jax.ops.iir import iir_cascade_xla
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients

NUM_STAGES = 10  # kernels_extra.metal caps the chain at 10


class BiquadChainBenchmark(StandardBufferBenchmark):
    name = "BiquadChain"
    tolerance = 1e-4

    def setup(self) -> None:
        self.setup_standard_buffers()
        # Staggered cutoffs fs/4 ... fs/8 across the cascade.
        self.stage_coeffs = [
            biquad_lowpass_coefficients(0.25 - 0.0125 * k)
            for k in range(NUM_STAGES)
        ]
        coeffs_arr = np.array(self.stage_coeffs, np.float32)
        self._coeffs_dev = self.put_replicated(coeffs_arr)
        self._zero_state = np.zeros((NUM_STAGES, self.track_count, 2), np.float32)

        import jax
        import jax.numpy as jnp

        def _chain(x, coeffs, states):
            y, zs = iir_cascade_xla(x, coeffs, states)
            return jnp.concatenate([y.ravel(), zs.ravel()])

        self._step = jax.jit(_chain)
        # Tuple-returning twin for the overlap tier, which must THREAD
        # the cascade state block-to-block (ADVICE r4 medium: passing
        # the same zero state to every block measured a stateless
        # variant while the docs claimed state was carried).
        self._step_pair = iir_cascade_xla

        # Golden: the same cascade through the float32 NumPy reference.
        y = self.host_input
        golden_states = np.zeros_like(self._zero_state)
        for k in range(NUM_STAGES):
            y, golden_states[k] = iir_reference(
                y, self.stage_coeffs[k], self._zero_state[k]
            )
        self.golden = y
        self.golden_states = golden_states
        self.host_states = None
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        states = self.put_spec(self._zero_state, None, "dp")
        buf = dev.from_device(self._step(x, self._coeffs_dev, states))
        n = self.total_elements()
        self.host_output = buf[:n].reshape(self.track_count, self.buffer_size)
        self.host_states = buf[n:].reshape(NUM_STAGES, self.track_count, 2)

    def overlap_body(self):
        """Input upload double-buffered against the cascade; the
        10-stage filter state carries block-to-block (mirrors
        models/iir.py overlap_body -- the true streaming dependency)."""
        step, coeffs = self._step_pair, self._coeffs_dev

        def f(x, states):
            y, states2 = step(x, coeffs, states)
            return y, states2

        return f, self.overlap_blocks(), self.put_spec(
            self._zero_state, None, "dp")

    def device_iterate(self) -> None:
        dev.block(
            self._step(
                self._resident_input, self._coeffs_dev,
                dev.to_device(self._zero_state),
            )
        )

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        x, coeffs = self._resident_input, self._coeffs_dev

        # Input in the carry, not the closure (models/iir.py
        # stream_body); the (K, 5) coeff table stays a closure constant.
        def step(carry):
            xc, states = carry
            y, zs = iir_cascade_xla(xc, coeffs, states)
            return (xc, zs), probe(y)

        return step, (x, dev.to_device(self._zero_state))

    def validate(self) -> ValidationData:
        v = compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} output",
        )
        v.merge_failure(
            compare_abs(
                self.host_states, self.golden_states, 1e-3,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} states",
            )
        )
        return v

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 9 * NUM_STAGES * n,
            "hbm_bytes": (2 * n + 4 * NUM_STAGES * self.track_count) * 4,
            "unit": "fp32",
        }

    def metadata(self):
        return {"numStages": NUM_STAGES}
