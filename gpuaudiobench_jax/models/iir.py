"""IIRFilter: per-track 2nd-order Butterworth lowpass biquad at fs/4,
Q = 0.707, Direct Form II (cuda/bench_iir.cu).

State semantics: like the reference, the filter state (z1, z2) per
track persists on-device across iterations (bench_iir.cu:19-43, written
back every run and never reset) and is read back each iteration
(bench_iir.cu:102). Unlike the reference -- whose golden is a single
pass from zero state, so its check is time-dependent after iteration 2
-- validation here runs the float32 NumPy reference once per performed
iteration, carrying state, and compares the LAST block's output and
final state (bench_iir.cu:105-117 tolerances).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.iir import iir_biquad_xla
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients


def iir_reference(
    x: np.ndarray, coeffs, state: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Float32 DF-II reference, op-order identical to bench_iir.cu:170-197
    but vectorized over tracks."""
    b0, b1, b2, a1, a2 = (np.float32(c) for c in coeffs)
    z1 = state[:, 0].copy()
    z2 = state[:, 1].copy()
    y = np.empty_like(x)
    for n in range(x.shape[1]):
        xn = x[:, n]
        w = xn - a1 * z1 - a2 * z2
        y[:, n] = b0 * w + b1 * z1 + b2 * z2
        z2 = z1
        z1 = w
    return y, np.stack([z1, z2], axis=1)


class IIRBenchmark(StandardBufferBenchmark):
    name = "IIRFilter"
    tolerance = 1e-4  # output, bench_iir.cu:106
    state_tolerance = 1e-3  # final state, bench_iir.cu:114

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.coeffs = biquad_lowpass_coefficients(0.25)  # fs/4 (bench_iir.cu:151)
        self._coeffs_dev = self.put_replicated(np.array(self.coeffs, dtype=np.float32))
        self._zero_state = np.zeros((self.track_count, 2), np.float32)
        self._state_dev = self.put_spec(self._zero_state, "dp") \
            if self._sharding is not None else dev.to_device(self._zero_state)
        self._timing_state = self._state_dev  # frozen copy for device timing
        self._invocations = 0
        self.host_state = None

        # Recurrence form (--iirForm): "scan" = the per-sample
        # sequential recurrence (reference semantics); "blockstate" =
        # m samples per step via precomputed tables (ops/iir.py). The
        # tables are ~m^2 floats -- deliberate closure constants.
        if self.cfg.iir_form == "blockstate":
            from gpuaudiobench_jax.ops.iir import (
                blockstate_effective_m,
                blockstate_tables,
                iir_biquad_blockstate,
            )

            # m = 0 means auto (16); always clamped to a divisor of the
            # buffer size.
            req = self.cfg.iir_block_m or 16
            self._block_m = blockstate_effective_m(self.buffer_size, req)
            taps, u = blockstate_tables(self.coeffs, self._block_m)
            taps_d, u_d = self.put_replicated(taps), self.put_replicated(u)

            def filt(x, c, z):
                return iir_biquad_blockstate(x, c, taps_d, u_d, z)
        else:
            filt = iir_biquad_xla
        self._filter = filt

        # Fuse output+state into one flat device array so the readback is
        # a single transfer.
        import jax
        import jax.numpy as jnp

        def _step(x, c, z):
            y, z2 = filt(x, c, z)
            return z2, jnp.concatenate([y.ravel(), z2.ravel()])

        self._step = jax.jit(_step)
        self.iterate()

    def iterate(self) -> None:
        # State stays device-resident and evolves across iterations
        # (the reference's persistent d_state); output + state read back
        # in one packed transfer (bench_iir.cu:100-102).
        x = self.put_input(self.host_input)
        self._state_dev, buf_dev = self._step(
            x, self._coeffs_dev, self._state_dev
        )
        buf = dev.from_device(buf_dev)
        n = self.total_elements()
        self.host_output = buf[:n].reshape(self.track_count, self.buffer_size)
        self.host_state = buf[n:].reshape(self.track_count, 2)
        self._invocations += 1

    def overlap_body(self):
        """Input upload double-buffered against the biquad scan; filter
        state carries block-to-block (the true streaming dependency)."""
        step, coeffs = self._step, self._coeffs_dev

        def f(x, state):
            state2, buf = step(x, coeffs, state)
            return buf, state2

        return f, self.overlap_blocks(), self._state_dev

    def device_iterate(self) -> None:
        y, _ = self._filter(
            self._resident_input, self._coeffs_dev, self._timing_state)
        dev.block(y)

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        filt = self._filter
        c = self._coeffs_dev

        # The input block rides the carry (returned unchanged, so XLA
        # aliases it): a closure capture serializes T x S x 4 bytes
        # into the compiled module (256 MB at 131072 tracks). The
        # 5-float coeff row stays a closure constant.
        def step(carry):
            x, z = carry
            y, z2 = filt(x, c, z)
            return (x, z2), probe(y)

        return step, (self._resident_input, self._timing_state)

    def cost_model(self):
        n = self.total_elements()
        return {
            "flops": 9 * n,  # w = x - a1 z1 - a2 z2; y = b0 w + b1 z1 + b2 z2
            "hbm_bytes": (2 * n + 4 * self.track_count) * 4,
            "unit": "fp32",
        }

    def validate(self) -> ValidationData:
        # Multi-iteration golden: carry the float32 state exactly as the
        # device does, validate the final block + state.
        state = self._zero_state.copy()
        golden = None
        for _ in range(self._invocations):
            golden, state = iir_reference(self.host_input, self.coeffs, state)
        self.golden, self.golden_state = golden, state
        v = compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} output",
        )
        v.merge_failure(
            compare_abs(
                self.host_state, self.golden_state, self.state_tolerance,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} state",
            )
        )
        return v

    def metadata(self):
        b0, b1, b2, a1, a2 = (float(c) for c in self.coeffs)
        md = {
            "filter": "butterworth_lowpass_fs4",
            "coefficients": {"b0": b0, "b1": b1, "b2": b2, "a1": a1, "a2": a2},
            "form": self.cfg.iir_form,
        }
        if self.cfg.iir_form == "blockstate":
            md["blockM"] = self._block_m
        return md
