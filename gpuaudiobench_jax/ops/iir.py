"""Biquad IIR filter: per-track Direct Form II recurrence.

Equivalent of IIRFilterKernel (cuda/bench_iir.cu:10-44): the reference
runs one CUDA thread per track, each sequentially looping over the
buffer. Here the recurrence order is preserved but vectorized the other
way: the *time* axis is the sequential scan and all tracks advance in
lockstep.

  w[n] = x[n] - a1*w[n-1] - a2*w[n-2]
  y[n] = b0*w[n] + b1*w[n-1] + b2*w[n-2]

State (z1, z2) = (w[n-1], w[n-2]) per track round-trips across calls
exactly like the reference's persistent d_state (bench_iir.cu:19-43).

Forms: ``iir_biquad_xla`` (lax.scan over the sample axis on a (S, T)
transposed block), ``iir_cascade_xla`` (K biquads in series, the
BiquadChain / DAWSessionMix EQ) and ``iir_biquad_blockstate`` (the
recurrence advanced m samples per step, below).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def iir_biquad_xla(x: jax.Array, coeffs: jax.Array, state: jax.Array):
    """x: (tracks, S) track-major; coeffs: (5,) = b0,b1,b2,a1,a2;
    state: (tracks, 2) = z1,z2. Returns (y, new_state)."""
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))
    xt = x.T  # (S, T): each scan step consumes one full lane-vector of tracks

    def step(carry, xn):
        z1, z2 = carry
        w = xn - a1 * z1 - a2 * z2
        y = b0 * w + b1 * z1 + b2 * z2
        return (w, z1), y

    (z1, z2), yt = jax.lax.scan(step, (state[:, 0], state[:, 1]), xt, unroll=8)
    return yt.T, jnp.stack([z1, z2], axis=1)


@jax.jit
def iir_cascade_xla(x: jax.Array, coeffs: jax.Array, states: jax.Array):
    """K biquads in series: x (tracks, S); coeffs (K, 5); states
    (K, tracks, 2). Returns (y, new_states (K, tracks, 2))."""
    y, zs = x, []
    for k in range(coeffs.shape[0]):
        y, z = iir_biquad_xla(y, coeffs[k], states[k])
        zs.append(z)
    return y, jnp.stack(zs)


# -- block-state form: the recurrence advanced m samples per step ------------
#
# The biquad is LINEAR, so the per-sample dependency chain is not
# fundamental: with s[n] = (w[n], w[n-1]) and A = [[-a1, -a2], [1, 0]],
#
#   s[n] = A s[n-1] + (x[n], 0)
#   w[n0+j] = (A^{j+1} s_prev)[0] + sum_{i<=j} p_{j-i} x[n0+i],
#
# where p_k = (A^k)[0,0] is the w-impulse response. One m-sample chunk
# is therefore ONE (T, m) x (m, m) lower-triangular-Toeplitz product
# plus a (T, 2) x (2, m) state term -- all-parallel inside the chunk --
# and the sequential chain shrinks from S scan steps to S/m, at
# ~(m/2 + 2) MACs/sample vs the scan's ~6: FLOPs traded for a shorter
# dependency chain. Same filter: tests pin bit-level-class agreement
# (<= 1e-5 abs) against the sequential f32 reference.


def blockstate_tables(coeffs, m: int):
    """Host-side f64-derived coefficient tables for the m-sample
    block-state form: (taps (m, m) lower-triangular Toeplitz of p_k,
    u (m, 2) rows of A^{j+1}[0, :]), float32.

    Tables depend only on (a1, a2, m): build once at setup from the
    concrete coefficients (the cuFFT-plan analog), never in-graph.
    """
    import numpy as np

    _, _, _, a1, a2 = (float(c) for c in coeffs)
    a = np.array([[-a1, -a2], [1.0, 0.0]], np.float64)
    powers = [np.eye(2)]
    for _ in range(m):
        powers.append(a @ powers[-1])
    p = np.array([powers[k][0, 0] for k in range(m)])
    taps = np.zeros((m, m))
    for j in range(m):
        taps[j, : j + 1] = p[j::-1]
    u = np.stack([powers[j + 1][0, :] for j in range(m)])
    return taps.astype(np.float32), u.astype(np.float32)


@functools.partial(jax.jit, static_argnames=())
def iir_biquad_blockstate(x: jax.Array, coeffs: jax.Array,
                          taps: jax.Array, u: jax.Array,
                          state: jax.Array):
    """Block-state biquad: x (tracks, S); coeffs (5,) = b0,b1,b2,a1,a2
    (only b* are read -- a* live in the tables); taps/u from
    blockstate_tables(m); state (tracks, 2) = (z1, z2).
    Returns (y, new_state). S must be a multiple of m.
    """
    b0, b1, b2 = coeffs[0], coeffs[1], coeffs[2]
    m = taps.shape[0]
    tracks, s = x.shape
    hi = jax.lax.Precision.HIGHEST
    xc = x.reshape(tracks, s // m, m).transpose(1, 0, 2)  # (chunks, T, m)

    def chunk(carry, xk):
        # carry: (T, 2) = s_prev = (w[-1], w[-2]) entering this chunk.
        w = (jnp.einsum("ti,ji->tj", xk, taps, precision=hi)
             + jnp.einsum("tc,jc->tj", carry, u, precision=hi))
        wm1 = jnp.concatenate([carry[:, :1], w[:, :-1]], axis=1)
        wm2 = jnp.concatenate([carry[:, 1:2], wm1[:, :-1]], axis=1)
        y = b0 * w + b1 * wm1 + b2 * wm2
        return w[:, -1:-3:-1], y  # new (z1, z2) = (w[m-1], w[m-2])

    z, yc = jax.lax.scan(chunk, state, xc)
    return yc.transpose(1, 0, 2).reshape(tracks, s), z


def blockstate_effective_m(s: int, block_m: int) -> int:
    """Largest divisor of s in [2, block_m] (pow-2 S gives pow-2 m).

    Raises if no such divisor exists (prime S, or S whose factors all
    exceed block_m): the blockstate form needs m >= 2 -- the carried
    state is w's last TWO rows, so the m = 1 "chunk" degenerates.
    """
    m = min(block_m, s)
    while m > 1 and s % m != 0:
        m -= 1
    if m < 2:
        raise ValueError(
            f"blockstate needs a buffer-size divisor in "
            f"[2, {min(block_m, s)}]; buffer_size {s} has none -- "
            "use --iirForm scan")
    return m
