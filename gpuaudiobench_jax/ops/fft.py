"""Batched real FFT (the cuFFT analog: XLA's FFT lowering).

JAX equivalent of FFTBenchmark (cuda/bench_fft.cu): batched
real-to-complex FFT of fixed size 1024 (cufftPlan1d R2C over nTracks,
bench_fft.cu:104-110), output (N/2+1) complex bins per track. XLA's
`jnp.fft.rfft` is the sanctioned vendor-library path, exactly as cuFFT
is for the CUDA build.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

FFT_SIZE = 1024  # bench_fft.cuh:440 (FFT_SIZE = 1024)


@functools.partial(jax.jit, static_argnames=("fft_size",))
def rfft_batched(x: jax.Array, fft_size: int = FFT_SIZE):
    """x: (tracks, fft_size) pre-padded real input. Returns (re, im),
    each (tracks, fft_size//2 + 1) float32."""
    spec = jnp.fft.rfft(x, n=fft_size, axis=-1)
    return jnp.real(spec).astype(jnp.float32), jnp.imag(spec).astype(jnp.float32)
