"""Modal filter bank: phasor-rotation sinusoid bank, plain XLA form.

The equivalent of the *real* modal bank (the Metal kernel
BenchmarkModalFilterBank, kernels_benchmark_staging.metal:121-162; the
CUDA ModalSynthesisKernel is a documented stub, bench_modal.cu:15-36).
Semantics per mode m with params (amp, freq, state):

  each sample: state *= e^{i*2*pi*freq}  (rotate first)
               out[m % output_tracks, s] += amp * Re(state)

The reference's cross-thread atomic float accumulation becomes a
deterministic reshape reduction: modes are laid out so mode m maps to
track m % T_out, i.e. a (M/T_out, T_out) fold summed over axis 0 --
no atomics, no race class.

The recurrence is kept iterative (not closed-form cos(w*s)) so float32
op order matches the per-sample CPU golden within tight tolerance.

This scan is the reference for the GPU kernel (ops/modal_triton.py)
and the block the CPU runs.
"""

from __future__ import annotations

import functools

import jax


@functools.partial(jax.jit, static_argnames=("buffer_size", "output_tracks"))
def modal_bank_xla(
    amp: jax.Array,
    cos_w: jax.Array,
    sin_w: jax.Array,
    state_re: jax.Array,
    state_im: jax.Array,
    buffer_size: int,
    output_tracks: int,
):
    """All mode params are (M,) float32 with M % output_tracks == 0.
    Returns (out (output_tracks, S) track-major, state_re', state_im').

    ``amp=None`` takes amp-prefolded states (``amp * state``), the
    contract of ``ops.modal_triton.modal_step``."""
    m = cos_w.shape[0]
    groups = m // output_tracks

    def step(carry, _):
        re, im = carry
        new_re = re * cos_w - im * sin_w
        new_im = re * sin_w + im * cos_w
        val = new_re if amp is None else amp * new_re
        contrib = val.reshape(groups, output_tracks).sum(axis=0)
        return (new_re, new_im), contrib

    (re, im), out_sn = jax.lax.scan(
        step, (state_re, state_im), None, length=buffer_size, unroll=4
    )
    return out_sn.T, re, im  # (T_out, S)
