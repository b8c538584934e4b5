"""Conv1D_accel: FFT-accelerated (fast) convolution
(cuda/bench_conv1d_accel.cu). IR length defaults to 512
(bench_conv1d_accel.cuh:506); fftSize = nextPow2(irLen + bufferSize - 1)
(bench_conv1d_accel.cu:52). IR spectra are precomputed once at setup
(the cuFFT-plan + precomputeImpulseResponseFFTs analog); per iteration:
zero-pad -> rfft -> pointwise complex multiply -> irfft -> first
bufferSize samples, written *interleaved* out[nTracks*i + track]
(ExtractRealPartKernel, bench_conv1d_accel.cu:41-46).

Golden = time-domain convolution clamped within each track
(conv1DCPUReference, bench_conv1d_accel.cu:230-252), relative tolerance
1e-3. Note: this build computes the correct normalized inverse FFT; the
reference's ExtractRealPartKernel reads the unnormalized cuFFT C2R
output through a stride-2 complex reinterpretation (a reference bug) --
the time-domain golden here validates the correct result.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.harness.validation import ValidationData, compare_rel
from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.conv import conv1d_fft, precompute_ir_spectra
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import conv1d_impulse_responses

DEFAULT_IR_LENGTH = 512  # bench_conv1d_accel.cuh:506


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class Conv1DAccelBenchmark(StandardBufferBenchmark):
    name = "Conv1D_accel"
    tolerance = 1e-3  # relative, bench_conv1d_accel.cu:310

    def setup(self) -> None:
        self.ir_length = self.cfg.ir_length or DEFAULT_IR_LENGTH
        self.fft_size = next_pow2(self.ir_length + self.buffer_size - 1)
        self.setup_standard_buffers()
        self.ir = conv1d_impulse_responses(self.track_count, self.ir_length)
        # Spectra stay device-resident as a float32 (re, im) pair:
        # complex64 buffers cannot cross host<->device on some PJRT
        # runtimes (ops/conv.py:precompute_ir_spectra).
        import jax

        spec = precompute_ir_spectra(dev.to_device(self.ir), self.fft_size)
        if self._sharding is not None:
            spec = jax.device_put(spec, self._sharding)
        self._ir_spec_dev = spec
        # Time-domain clamped golden, interleaved layout (cu:230-252).
        t, s = self.host_input.shape
        g = np.empty((t, s), np.float64)
        x64 = self.host_input.astype(np.float64)
        ir64 = self.ir.astype(np.float64)
        for track in range(t):
            g[track] = np.convolve(x64[track], ir64[track])[:s]
        self.golden = g.T.astype(np.float32).ravel()  # out[T*i + t]
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y = conv1d_fft(x, self._ir_spec_dev, self.fft_size, self.buffer_size)
        self.host_output = dev.from_device(y).T.ravel()  # interleave

    def device_iterate(self) -> None:
        dev.block(
            conv1d_fft(
                self._resident_input, self._ir_spec_dev, self.fft_size,
                self.buffer_size,
            )
        )

    def overlap_body(self):
        spec, n, s = self._ir_spec_dev, self.fft_size, self.buffer_size
        return (lambda x, c: (conv1d_fft(x, spec, n, s), c),
                self.overlap_blocks(), ())

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(
            lambda x: conv1d_fft(
                x, self._ir_spec_dev, self.fft_size, self.buffer_size
            ),
            self._resident_input,
        )

    def cost_model(self):
        t, s, f = self.track_count, self.buffer_size, self.fft_size
        import math

        fft_flops = 2.5 * f * math.log2(f)  # real-FFT flop model, per track
        bins = f // 2 + 1
        return {
            "flops": int(t * (2 * fft_flops + 6 * bins)),
            "hbm_bytes": (t * s * 2 + t * bins * 2) * 4,
            "unit": "fp32",
        }

    def validate(self) -> ValidationData:
        # Relative-to-peak metric (error <= tol * max|golden|, the DSP
        # full-scale convention): the reference's per-sample relative
        # metric diverges at zero crossings of the convolution output,
        # where f32 FFT rounding (~1e-6 absolute) is unbounded relative
        # to a ~0 golden; the reference platforms hit the same floor
        # (Metal records maxError as metadata rather than gating on it).
        floor = float(np.abs(self.golden).max())
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def metadata(self):
        return {"irLength": self.ir_length, "fftSize": self.fft_size}
