"""Spatially-sharded 3-D FDTD: domain decomposition over the mesh.

The single-device block (ops/fdtd3d.py) carries the whole 52^3 grid on
one device; this variant shards the x-axis of the room over a mesh
axis, exchanging one pressure plane per neighbor per substep (ppermute
halo exchange) -- the classic stencil domain decomposition, and the
scaling path for rooms larger than one device's memory/FLOPs.

Face ownership: shard i holds pressure rows [i*R, (i+1)*R) and velocity
faces [i*R, (i+1)*R] inclusive -- boundary faces are computed
redundantly on both neighbors from the exchanged halos, so no second
communication round is needed for the divergence.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gpuaudiobench_jax.ops import fdtd3d as C


def make_fdtd_sharded_block(mesh: Mesh, axis: str = "sp",
                            steps_per_sample: int = C.STEPS_PER_SAMPLE):
    """Returns jitted fn(x (tracks, S)) -> out (tracks, S) running the
    whole FDTD block with the room's x-axis sharded over `axis`.
    Fields are zero-initialized per block (benchmark semantics)."""
    nshards = mesh.shape[axis]
    n = C.GRID_N
    if n % nshards != 0:
        raise ValueError(f"grid {n} not divisible by {nshards} shards")
    rows = n // nshards
    k1 = jnp.float32(C.DT_OVER_RHO_DX)
    k2 = jnp.float32(C.RHO_C2_DT_OVER_DX)
    absorb = jnp.float32(1.0 - C.ABSORPTION)
    sx, sy, sz = C.SOURCE
    rx, ry, rz = C.RECEIVER
    fwd_perm = [(i, (i + 1) % nshards) for i in range(nshards)]
    bwd_perm = [(i, (i - 1) % nshards) for i in range(nshards)]

    def local_block(x):
        tracks, s = x.shape
        idx = jax.lax.axis_index(axis)
        r0 = idx * rows

        gx = r0 + jax.lax.broadcasted_iota(jnp.int32, (rows, n, n), 0)
        gy = jax.lax.broadcasted_iota(jnp.int32, (rows, n, n), 1)
        gz = jax.lax.broadcasted_iota(jnp.int32, (rows, n, n), 2)
        boundary = (
            (gx == 0) | (gx == n - 1) | (gy == 0) | (gy == n - 1)
            | (gz == 0) | (gz == n - 1)
        )
        # faces this shard computes: global face index in [1, n-1]
        gfx = r0 + jax.lax.broadcasted_iota(jnp.int32, (rows + 1, n, n), 0)
        fmask = ((gfx >= 1) & (gfx <= n - 1)).astype(jnp.float32)
        src_mask = ((gx == sx) & (gy == sy) & (gz == sz)).astype(jnp.float32)
        rcv_mask = ((gx == rx) & (gy == ry) & (gz == rz)).astype(jnp.float32)

        p0 = jnp.zeros((rows, n, n), jnp.float32)
        vx0 = jnp.zeros((rows + 1, n, n), jnp.float32)
        vy0 = jnp.zeros((rows, n + 1, n), jnp.float32)
        vz0 = jnp.zeros((rows, n, n + 1), jnp.float32)
        src = jnp.sum(x, axis=0) * jnp.float32(C.SOURCE_SCALE)

        def substep(_, fields):
            p, vx, vy, vz = fields
            # one-plane halo exchange per direction (edge wrap is masked)
            left = jax.lax.ppermute(p[-1:], axis, fwd_perm)
            right = jax.lax.ppermute(p[:1], axis, bwd_perm)
            p_ext = jnp.concatenate([left, p, right], axis=0)  # (rows+2,n,n)
            vx = vx - k1 * fmask * (p_ext[1:] - p_ext[:-1])
            vy = vy.at[:, 1:n, :].add(-k1 * (p[:, 1:, :] - p[:, :-1, :]))
            vz = vz.at[:, :, 1:n].add(-k1 * (p[:, :, 1:] - p[:, :, :-1]))
            div = (
                (vx[1:] - vx[:-1])
                + (vy[:, 1:, :] - vy[:, :-1, :])
                + (vz[:, :, 1:] - vz[:, :, :-1])
            )
            p = jnp.where(boundary, p * absorb, p - k2 * div)
            return (p, vx, vy, vz)

        def per_sample(fields, src_n):
            p, vx, vy, vz = fields
            p = p + src_mask * src_n
            p, vx, vy, vz = jax.lax.fori_loop(
                0, steps_per_sample, substep, (p, vx, vy, vz)
            )
            rcv = jnp.sum(rcv_mask * p)  # nonzero on the owning shard only
            return (p, vx, vy, vz), rcv

        _, rcv = jax.lax.scan(per_sample, (p0, vx0, vy0, vz0), src)
        rcv = jax.lax.psum(rcv, axis) * jnp.float32(C.OUTPUT_SCALE)  # (S,)
        return jnp.broadcast_to(rcv[None, :], (tracks, s))

    spec_rep = P()
    fn = shard_map(
        local_block, mesh=mesh, in_specs=(spec_rep,), out_specs=spec_rep,
        check_vma=False,
    )
    return jax.jit(fn)
