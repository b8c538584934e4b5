"""gpuaudiobench_jax: the GPGPU audio benchmark suite, rebuilt in JAX.

A suite of 17 real-time-audio micro/domain benchmarks (kernel-dispatch
overhead, host<->device transfer at five I/O ratios, gain, gain+stats, biquad
IIR, direct & FFT-accelerated 1-D convolution, batched real FFT, modal
phasor-bank synthesis, digital-waveguide strings, 3-D FDTD room acoustics,
random-memory access) implemented as jitted XLA programs and one Pallas
GPU kernel, on a shared harness: setup -> warmup -> N timed iterations (each
a full host->device->kernel->host round trip) -> percentile statistics vs. the
48 kHz buffer deadline -> golden-case validation against NumPy CPU
references -> CSV/JSON output.

Feature-parity target: the reference CUDA harness surface
(cuda/main.cu, globals.cu) plus the Metal harness
extensions (benchmark filters, verification modes, DAW-load simulation).
"""

__version__ = "0.1.0"

from gpuaudiobench_jax.config import BenchConfig  # noqa: F401
from gpuaudiobench_jax.registry import (  # noqa: F401
    BENCHMARK_NAMES,
    create_benchmark,
    list_benchmarks,
)
