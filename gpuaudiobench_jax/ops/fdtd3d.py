"""3-D FDTD room acoustics on a staggered (Yee) pressure-velocity grid.

Equivalent of the four CUDA kernels in bench_fdtd3d.cu:14-139 (inject
source / update velocity / update pressure / extract receiver). The
CUDA build dispatches 512 samples x 3 steps x 2-4 kernels per timed
iteration with a device sync per sample (bench_fdtd3d.cu:384-438);
here all bufferSize x stepsPerSample steps are fused into ONE jitted
program (a lax.scan over samples with an unrolled inner step loop) --
the Metal single-command-buffer strategy (FDTD3DBenchmark.swift:408-480)
taken further, since per-step host round trips would dominate.

Update equations (float32, absorbing boundaries):
  vx[x,y,z]  -= dt/(rho*dx) * (p[x,y,z] - p[x-1,y,z])       x in [1, nx-1]
  (vy, vz analogous on their staggered axes)
  p[interior] -= rho*c^2*dt/dx * div(v)
  p[boundary] *= (1 - absorption)
  step 0 of each sample:  p[src] += sum_tracks(in[track, n]) * 0.1
  last step:              out[n]  = p[rcv] * 0.1  (broadcast to all tracks)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Physics constants (bench_fdtd3d.cuh:145-174).
ROOM = 50  # reference default; --fdtdRoom makes it configurable
GRID_N = ROOM + 2  # +2 ghost/boundary cells
SOUND_SPEED = 343.0
SPATIAL_STEP = 0.01
AIR_DENSITY = 1.225
ABSORPTION = 0.2
CFL = 0.5
STEPS_PER_SAMPLE = 3  # kFDTD3D_StepsPerSample
TIME_STEP = CFL * SPATIAL_STEP / (SOUND_SPEED * 1.7320508)
# Room coordinates (25,25,5)/(40,15,25) plus the one-cell ghost/boundary
# offset: the reference injects at grid (26,26,6) and reads (41,16,26)
# in the 52^3 grid (bench_fdtd3d.cu source/receiver indexing; fixed in
# round 2 -- round 1 used the unshifted room coordinates).
SOURCE = (26, 26, 6)
RECEIVER = (41, 16, 26)
SOURCE_SCALE = 0.1  # benchmark_constants.cuh FDTD3D_SOURCE_SCALE
OUTPUT_SCALE = 0.1


def grid_n(room: int) -> int:
    return room + 2


def source_pos(room: int) -> tuple:
    """Source grid cell for a given room size: the reference's room
    fractions (0.5, 0.5, 0.1) of (25,25,5)-in-50, floored, plus the
    one-cell ghost offset. At room=50 this IS the reference's
    (26, 26, 6) (bench_fdtd3d.cu source indexing); the WebGPU build
    scales positions with its configurable grid the same way
    (ParameterBuilder.js fdtdParams room 10-100)."""
    return (room // 2 + 1, room // 2 + 1, room // 10 + 1)


def receiver_pos(room: int) -> tuple:
    """Receiver grid cell: room fractions (0.8, 0.3, 0.5) of
    (40,15,25)-in-50 plus the ghost offset; (41, 16, 26) at room=50."""
    return (room * 8 // 10 + 1, room * 3 // 10 + 1, room // 2 + 1)

DT_OVER_RHO_DX = TIME_STEP / (AIR_DENSITY * SPATIAL_STEP)
RHO_C2_DT_OVER_DX = AIR_DENSITY * SOUND_SPEED**2 * TIME_STEP / SPATIAL_STEP


def _boundary_mask(n: int) -> jnp.ndarray:
    idx = jnp.arange(n)
    edge = (idx == 0) | (idx == n - 1)
    bx = edge[:, None, None] | edge[None, :, None] | edge[None, None, :]
    return bx


def _fdtd_substep(p, vx, vy, vz, boundary):
    """One velocity+pressure update (bench_fdtd3d.cu:14-98)."""
    n = p.shape[0]
    k1 = jnp.float32(DT_OVER_RHO_DX)
    k2 = jnp.float32(RHO_C2_DT_OVER_DX)

    vx = vx.at[1:n, :, :].add(-k1 * (p[1:, :, :] - p[:-1, :, :]))
    vy = vy.at[:, 1:n, :].add(-k1 * (p[:, 1:, :] - p[:, :-1, :]))
    vz = vz.at[:, :, 1:n].add(-k1 * (p[:, :, 1:] - p[:, :, :-1]))

    div = (
        (vx[1:, :, :] - vx[:-1, :, :])
        + (vy[:, 1:, :] - vy[:, :-1, :])
        + (vz[:, :, 1:] - vz[:, :, :-1])
    )
    interior = p - k2 * div
    # Interior cells get the stencil update; boundary cells get absorption.
    p = jnp.where(boundary, p * jnp.float32(1.0 - ABSORPTION), interior)
    return p, vx, vy, vz


@functools.partial(
    jax.jit,
    static_argnames=("steps_per_sample", "source", "receiver"))
def fdtd3d_block(
    x: jax.Array,  # (tracks, S) input block
    p: jax.Array,  # (N, N, N) pressure
    vx: jax.Array,  # (N+1, N, N)
    vy: jax.Array,  # (N, N+1, N)
    vz: jax.Array,  # (N, N, N+1)
    steps_per_sample: int = STEPS_PER_SAMPLE,
    source: tuple = SOURCE,
    receiver: tuple = RECEIVER,
):
    """Runs S samples x steps_per_sample FDTD steps in one program.
    Returns (out (tracks, S), p', vx', vy', vz'). The grid size rides
    the field shapes; source/receiver are static cells (the defaults
    are the reference's room-50 positions)."""
    n = p.shape[0]
    boundary = _boundary_mask(n)
    sx, sy, sz = source
    rx, ry, rz = receiver
    # Soft source: all tracks atomically add at the same cell
    # (bench_fdtd3d.cu:101-120) == sum over tracks.
    src_per_sample = jnp.sum(x, axis=0) * jnp.float32(SOURCE_SCALE)  # (S,)

    def per_sample(carry, src_n):
        p, vx, vy, vz = carry
        p = p.at[sx, sy, sz].add(src_n)  # inject on substep 0 only
        for _ in range(steps_per_sample):
            p, vx, vy, vz = _fdtd_substep(p, vx, vy, vz, boundary)
        out_n = p[rx, ry, rz] * jnp.float32(OUTPUT_SCALE)
        return (p, vx, vy, vz), out_n

    (p, vx, vy, vz), rcv = jax.lax.scan(per_sample, (p, vx, vy, vz), src_per_sample)
    tracks = x.shape[0]
    out = jnp.broadcast_to(rcv[None, :], (tracks, rcv.shape[0]))
    return out, p, vx, vy, vz


def receiver_line(tracks: int, n: int = GRID_N):
    """Per-track receiver positions: a line across x at mid y/z (the
    WebGPU convention, webgpu/js/benchmarks/FDTD3DBenchmark.js:57-67:
    x spans the room, y = ny/2, z = nz/2), carried into this grid's
    one-cell ghost offset: room coordinates map to grid [1, n-2], so
    edge tracks read interior cells rather than the absorbing boundary
    ring (same offset as SOURCE/RECEIVER above)."""
    import numpy as np

    i = np.arange(tracks)
    ratio = i / (tracks - 1) if tracks > 1 else np.full(tracks, 0.5)
    xs = (1 + np.floor(ratio * (n - 3))).astype(np.int32)  # [1, n-2]
    ys = np.full(tracks, n // 2, np.int32)
    zs = np.full(tracks, n // 2, np.int32)
    return xs, ys, zs


@functools.partial(
    jax.jit, static_argnames=("steps_per_sample", "source"))
def fdtd3d_block_multircv(
    x: jax.Array,       # (tracks, S)
    p: jax.Array, vx: jax.Array, vy: jax.Array, vz: jax.Array,
    rcv_flat: jax.Array,  # (tracks,) int32 flat indices into p.ravel()
    steps_per_sample: int = STEPS_PER_SAMPLE,
    source: tuple = SOURCE,
):
    """Per-track-receiver variant (WebGPU parity: every track reads its
    own cell, fdtd3d.wgsl binding 18). Returns (out (tracks, S), fields')."""
    n = p.shape[0]
    boundary = _boundary_mask(n)
    sx, sy, sz = source
    src_per_sample = jnp.sum(x, axis=0) * jnp.float32(SOURCE_SCALE)

    def per_sample(carry, src_n):
        p, vx, vy, vz = carry
        p = p.at[sx, sy, sz].add(src_n)
        for _ in range(steps_per_sample):
            p, vx, vy, vz = _fdtd_substep(p, vx, vy, vz, boundary)
        out_n = p.ravel()[rcv_flat] * jnp.float32(OUTPUT_SCALE)  # (tracks,)
        return (p, vx, vy, vz), out_n

    (p, vx, vy, vz), rcv = jax.lax.scan(
        per_sample, (p, vx, vy, vz), src_per_sample
    )
    return rcv.T, p, vx, vy, vz  # (tracks, S)


def zero_fields(n: int = GRID_N):
    return (
        jnp.zeros((n, n, n), jnp.float32),
        jnp.zeros((n + 1, n, n), jnp.float32),
        jnp.zeros((n, n + 1, n), jnp.float32),
        jnp.zeros((n, n, n + 1), jnp.float32),
    )
