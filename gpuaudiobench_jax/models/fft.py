"""FFT1D: batched real-to-complex FFT, size fixed 1024
(cuda/bench_fft.cu; cufftPlan1d R2C over nTracks). Input is random +-1
per track, zero-padded when bufferSize < 1024, truncated above
(bench_fft.cu:33-42). Output layout: per track, (N/2+1) interleaved
[re, im] pairs (cufftComplex). Golden = NumPy rfft in float64 (the
reference's O(N^2) DFT computes the same values); error metric
|d_re| + |d_im| <= 1e-3 (bench_fft.cu:79-98).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_complex
from gpuaudiobench_jax.ops.fft import FFT_SIZE, rfft_batched
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import generate_random_audio


class FFTBenchmark(Benchmark):
    name = "FFT1D"
    tolerance = 1e-3  # bench_fft.cu:93

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)
        self.fft_size = FFT_SIZE
        self.bins = self.fft_size // 2 + 1

    def setup(self) -> None:
        t, s = self.track_count, self.buffer_size
        self.setup_sharding(t)
        n = min(s, self.fft_size)
        data = generate_random_audio(t * n, self.cfg.seed).reshape(t, n)
        self.host_input = np.zeros((t, self.fft_size), np.float32)
        self.host_input[:, :n] = data
        self._resident_input = self.put_sharded(self.host_input)
        self.track_alloc("inputBuffers", self.host_input.nbytes * 2)
        self.track_alloc("outputBuffers", t * self.bins * 8 * 2)
        spec = np.fft.rfft(self.host_input.astype(np.float64), axis=-1)
        self.golden_re = spec.real.astype(np.float32)
        self.golden_im = spec.imag.astype(np.float32)
        self.host_re = None
        self.host_im = None

        # Single-transfer readback: interleave [re, im] on device -- this
        # is also the cufftComplex output layout (bench_fft.cu h_output_fft).
        import jax
        import jax.numpy as jnp

        def _step(x):
            re, im = rfft_batched(x, self.fft_size)
            return jnp.stack([re, im], axis=-1)  # (T, bins, 2)

        self._step = jax.jit(_step)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_sharded(self.host_input)
        buf = dev.from_device(self._step(x))
        self.host_re = buf[..., 0]
        self.host_im = buf[..., 1]

    def device_iterate(self) -> None:
        re, im = rfft_batched(self._resident_input, self.fft_size)
        dev.block((re, im))

    def overlap_body(self):
        step = self._step
        import numpy as _np

        return (lambda x, c: (step(x), c),
                [self.host_input, _np.negative(self.host_input)], ())

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(
            lambda x: rfft_batched(x, self.fft_size), self._resident_input
        )

    def validate(self) -> ValidationData:
        return compare_complex(
            self.host_re, self.host_im, self.golden_re, self.golden_im,
            self.tolerance, mode=self.cfg.verification,
            limit=self.cfg.spot_sample_limit, label=self.name,
        )

    def total_elements(self) -> int:
        return self.track_count * self.fft_size

    def bytes_processed(self) -> int:
        # real input + complex output (bench_fft.cu buffer sizes)
        return self.track_count * (self.fft_size * 4 + self.bins * 8)

    def cost_model(self):
        import math

        t, f = self.track_count, self.fft_size
        return {
            "flops": int(t * 2.5 * f * math.log2(f)),
            "hbm_bytes": t * (f * 4 + self.bins * 8),
            "unit": "fp32",
        }

    def metadata(self):
        return {"fftSize": self.fft_size, "bins": self.bins}

