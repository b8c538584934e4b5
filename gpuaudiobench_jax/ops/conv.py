"""1-D convolution ops: direct FIR and FFT-accelerated (fast) convolution.

Equivalents of:
* Conv1DTextureMemoryImplKernel (cuda/bench_conv1d.cu:7-27): per-track
  direct FIR with per-track IRs. The CUDA thread-per-track O(S*L) loop
  becomes one grouped (depthwise) convolution; the texture-memory IR
  bank becomes a device-resident (T, L) array.
  Edge handling is selectable: "clamp" confines the IR window to each
  track (Metal/accel semantics, Convolution1DBaseBenchmark.swift:94-115);
  "bleed" reproduces the CUDA flat-buffer indexing where the window runs
  into the previous track's tail (bench_conv1d.cu:20-22).
* Conv1D_accel (cuda/bench_conv1d_accel.cu): forward rfft of the
  zero-padded block, pointwise complex multiply with IR spectra
  precomputed at setup (the cuFFT-plan + precomputeImpulseResponseFFTs
  analog), inverse rfft, first S samples kept. Unlike the reference's
  ExtractRealPartKernel (which reads the unnormalized C2R output at a
  stride-2 offset -- a reference bug), this computes the mathematically
  correct fast convolution, which is what its time-domain golden
  validates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _depthwise_conv(x_padded: jax.Array, ir: jax.Array) -> jax.Array:
    """Correlate left-padded (T, S+L-1) input with reversed IRs (T, L):
    out[t, i] = sum_j ir[t, j] * x_padded[t, i + (L-1) - j]."""
    t, l = ir.shape
    lhs = x_padded[None]  # (1, T, S+L-1)
    rhs = ir[:, None, ::-1]  # (T, 1, L) reversed -> convolution
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=t,
        preferred_element_type=jnp.float32,
    )
    return out[0]


@functools.partial(jax.jit, static_argnames=("edge_mode",))
def conv1d_direct(x: jax.Array, ir: jax.Array,
                  edge_mode: str = "clamp") -> jax.Array:
    """Direct per-track FIR. x: (T, S); ir: (T, L). Returns (T, S).

    edge_mode "clamp": window confined within each track (zeros before
    sample 0). "bleed": window continues into the previous track's tail
    in flat track-major order (CUDA quirk, bench_conv1d.cu:20-22).
    """
    t, s = x.shape
    l = ir.shape[1]
    if edge_mode == "clamp":
        pad = jnp.zeros((t, l - 1), x.dtype)
    else:  # bleed: previous track's last L-1 samples (zeros for track 0)
        tails = x[:, s - (l - 1):] if l - 1 <= s else jnp.pad(
            x, ((0, 0), (l - 1 - s, 0))
        )
        prev = jnp.roll(tails, 1, axis=0).at[0].set(0.0)
        pad = prev
    x_padded = jnp.concatenate([pad, x], axis=1)
    return _depthwise_conv(x_padded, ir)


@functools.partial(jax.jit, static_argnames=("fft_size",))
def precompute_ir_spectra(ir: jax.Array, fft_size: int):
    """IR spectra for fast convolution (precomputeImpulseResponseFFTs
    analog, cuda/bench_conv1d_accel.cu:254-304). Returns float32
    (re, im), each (T, fft_size//2+1): some PJRT runtimes cannot
    transfer complex64 buffers at all, and a complex array crossing a
    jit capture boundary may be re-staged through the host -- float
    pairs keep the spectra portable while the complex math stays inside
    the jitted program."""
    spec = jnp.fft.rfft(ir, n=fft_size, axis=-1)
    return jnp.real(spec).astype(jnp.float32), jnp.imag(spec).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("fft_size", "out_len"))
def conv1d_fft(x: jax.Array, ir_spec, fft_size: int, out_len: int):
    """Fast convolution: irfft(rfft(x) * ir_spec)[:, :out_len].
    x: (T, S) real; ir_spec: (re, im) float32 pair, each (T, F).
    Returns (T, out_len)."""
    sr, si = ir_spec
    spec = jnp.fft.rfft(x, n=fft_size, axis=-1)
    y = jnp.fft.irfft(spec * jax.lax.complex(sr, si), n=fft_size, axis=-1)
    return y[:, :out_len].astype(jnp.float32)
