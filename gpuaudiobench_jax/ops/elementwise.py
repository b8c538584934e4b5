"""Elementwise / reduction ops: noop copy, gain, gain+stats, data transfer.

JAX equivalents of:
* NoOpKernel (cuda/bench_noop.cu:9-16): validatable copy.
* GainKernel (cuda/bench_gain.cu:6-24): out = gain * in.
* GainStatsKernel (cuda/bench_gainstats.cu:7-31): out = 0.5 * in plus a
  per-track [mean(in), max(in)] stats buffer -- the reference's
  thread-per-track loop becomes a lane-vectorized row reduction.
* DataTransferKernel (cuda/bench_datatransfer.cu:15-25): copy the input
  portion, synthesize 0.5 + 0.5*sin(idx*0.001) beyond it.

These are single fused XLA programs; a hand-written Pallas kernel cannot
beat XLA's fusion for pure elementwise/reduction work, so no Pallas
variant exists (the Pallas effort goes to the recurrences/stencils).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def copy_op(x: jax.Array) -> jax.Array:
    """Validatable no-op: out = in (bench_noop.cu:9-16)."""
    return x + 0.0  # force a materialized copy rather than aliasing


@functools.partial(jax.jit, static_argnames=("gain",))
def gain_op(x: jax.Array, gain: float) -> jax.Array:
    return gain * x


@functools.partial(jax.jit, static_argnames=("gain",))
def gain_stats_op(x: jax.Array, gain: float):
    """Gain + per-track [mean, max] of the *input* (bench_gainstats.cu:15-30
    reduces `samp = bufIn[idx]`, not the scaled output).

    x: (tracks, buffer_size) track-major. Returns (out, stats) with
    stats[t] = [mean(x[t]), max(x[t])] in the reference's tracks x 2
    layout (NSTATS=2).
    """
    out = gain * x
    mean = jnp.mean(x, axis=1)
    mx = jnp.max(x, axis=1)
    stats = jnp.stack([mean, mx], axis=1)
    return out, stats


@functools.partial(jax.jit, static_argnames=("out_size",))
def data_transfer_op(x: jax.Array, out_size: int) -> jax.Array:
    """out[i] = x[i] for i < len(x), else 0.5 + 0.5*sin(i*0.001)
    (bench_datatransfer.cu:15-25). x is the 1-D input portion."""
    in_size = x.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.float32, (out_size, 1), 0)[:, 0]
    synth = 0.5 + 0.5 * jnp.sin(idx * jnp.float32(0.001))
    if out_size <= in_size:
        return x[:out_size] + 0.0
    return jnp.concatenate([x, synth[in_size:]])
