"""Modal phasor bank as one Pallas kernel through Triton (GPU).

The XLA form (``ops/modal.py``) is a ``lax.scan`` over the buffer's
samples: every step streams the whole (M,) mode state and its rotation
tables through device memory, about 28 bytes per mode per sample. This
kernel keeps each program's share of the bank in registers for the
whole buffer and loops over the samples inside the kernel, so a block
reads the tables and the state once and writes the state once.

Layout: mode ``m`` feeds output track ``m % T``, so the (M,) bank is
viewed as (G, T) with G = M / T groups. A program owns a tile of
``tile_groups`` consecutive groups, shaped (tile_groups, Tp) with the
track axis padded to a power of two (Triton's block shapes are powers
of two). Each sample, the program rotates its tile and sums it over the
groups axis inside the block, giving one (Tp,) row. Programs write
per-program partial (S, Tp) blocks and XLA sums them over programs: no
atomics, so the output is the same on every run.

The state is amp-prefolded (``re_f = amp * state_re``): the rotation is
linear, so the per-sample contribution is just ``Re(state)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Groups per program and warps per program. A tile of 128 groups x 32
# tracks holds 32 modes per thread at 4 warps, and 1M modes make 256
# programs, about two per SM of the 132 on an H100. Swept at 1M x 32 x
# 512 on an H100 80GB HBM3 at 700 W (PERF.md): 32 modes per thread beat
# 16 at every tile size, and tile 128 / 4 warps sat within noise of the
# fastest (tile 32 / 1 warp) with a quarter of its partial-sum traffic.
TILE_GROUPS = 128
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def tile_groups(groups: int, max_tile: int = TILE_GROUPS) -> int:
    """Groups per program: ``max_tile``, or the smallest power of two
    that covers a smaller bank (one program)."""
    return min(max_tile, _next_pow2(groups))


def padded_shape(num_modes: int, output_tracks: int,
                 max_tile: int = TILE_GROUPS):
    """(groups_padded, tracks_padded, tile) for a bank of ``num_modes``
    modes (a multiple of ``output_tracks``) folded onto
    ``output_tracks`` tracks."""
    if num_modes % output_tracks:
        raise ValueError(
            f"num_modes ({num_modes}) must be a multiple of "
            f"output_tracks ({output_tracks})")
    groups = num_modes // output_tracks
    tile = tile_groups(groups, max_tile)
    return -(-groups // tile) * tile, _next_pow2(output_tracks), tile


def _kernel(cos_ref, sin_ref, re_ref, im_ref, out_ref, re_out_ref,
            im_out_ref, *, buffer_size: int):
    cos_w = cos_ref[...]
    sin_w = sin_ref[...]

    def body(s, carry):
        re, im = carry
        re, im = re * cos_w - im * sin_w, re * sin_w + im * cos_w
        out_ref[s, :] = jnp.sum(re, axis=0)
        return re, im

    re, im = jax.lax.fori_loop(0, buffer_size, body,
                               (re_ref[...], im_ref[...]))
    re_out_ref[...] = re
    im_out_ref[...] = im


@functools.partial(
    jax.jit,
    static_argnames=("buffer_size", "output_tracks", "max_tile",
                     "num_warps", "interpret"),
)
def modal_step(cos_w, sin_w, re_f, im_f, buffer_size: int,
               output_tracks: int, max_tile: int = TILE_GROUPS,
               num_warps: int = NUM_WARPS, interpret: bool = False):
    """One block of the bank on amp-prefolded (M,) float32 states.

    Returns ``(out (output_tracks, S), re_f', im_f')`` with the rotated
    states, so blocks chain by feeding the states back. ``interpret``
    runs the kernel through the Pallas interpreter (tests on the CPU).
    """
    m = cos_w.shape[0]
    t = output_tracks
    gp, tp, tile = padded_shape(m, t, max_tile)
    g = m // t

    def grid2d(a, fill):
        a = a.reshape(g, t)
        return jnp.pad(a, ((0, gp - g), (0, tp - t)), constant_values=fill)

    # Padded modes have zero state and a unit rotation: they add nothing.
    args = (grid2d(cos_w, 1.0), grid2d(sin_w, 0.0),
            grid2d(re_f, 0.0), grid2d(im_f, 0.0))
    n_prog = gp // tile
    tile_spec = pl.BlockSpec((tile, tp), lambda i: (i, 0))
    partial, re2, im2 = pl.pallas_call(
        functools.partial(_kernel, buffer_size=buffer_size),
        out_shape=(
            jax.ShapeDtypeStruct((n_prog, buffer_size, tp), jnp.float32),
            jax.ShapeDtypeStruct((gp, tp), jnp.float32),
            jax.ShapeDtypeStruct((gp, tp), jnp.float32),
        ),
        grid=(n_prog,),
        in_specs=[tile_spec] * 4,
        out_specs=(
            pl.BlockSpec((None, buffer_size, tp), lambda i: (i, 0, 0)),
            tile_spec,
            tile_spec,
        ),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="modal_bank",
    )(*args)
    out = partial.sum(axis=0)[:, :t].T
    return (out, re2[:g, :t].reshape(m), im2[:g, :t].reshape(m))
