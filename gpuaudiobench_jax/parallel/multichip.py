"""Multi-device suite step: the full audio pipeline sharded over a mesh.

The reference is strictly single-device; this module is the
multi-device extension (SURVEY.md s2.4), exercising every applicable
parallelism axis with XLA collectives (NCCL over NVLink between GPUs).
Every GPU of a host reaches every other at the same rate, so the mesh
shape follows the algorithm, not a link topology:

* dp  (data parallel): tracks/voices sharded; purely elementwise+scan,
  no communication (the reference's thread-per-track axis across
  devices).
* tp  (tensor parallel): the modal bank's mode axis sharded; each device
  rotates a partial bank and the per-track accumulation completes with a
  psum over "tp" (replacing the reference's atomic adds with a
  collective reduction).
* sp  (sequence parallel): the sample axis of the FIR convolution
  sharded, with a halo exchange (ppermute) shipping each shard's IR
  tail to its right neighbor -- the block-convolution analog of
  ring/halo attention.
* pp  (pipeline parallel): a serial effect chain (cascaded biquad
  stages, one stage per "tp" rank) pipelined GPipe-style over
  microbatches of tracks with ppermute handoffs between stages.
* ep: n/a in this domain (no MoE); documented in SURVEY.md s2.4.

Everything is a single jitted program over the mesh; run ONE step on
tiny shapes via dryrun (see __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpuaudiobench_jax.ops.modal import modal_bank_xla
from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients


def _biquad_block(x: jax.Array, coeffs: jax.Array) -> jax.Array:
    """DF-II biquad over (T, S) from zero state (local, no comm)."""
    b0, b1, b2, a1, a2 = (coeffs[i] for i in range(5))

    def step(carry, xn):
        z1, z2 = carry
        w = xn - a1 * z1 - a2 * z2
        y = b0 * w + b1 * z1 + b2 * z2
        return (w, z1), y

    t = x.shape[0]
    z0 = (jnp.zeros(t, x.dtype), jnp.zeros(t, x.dtype))
    _, yt = jax.lax.scan(step, z0, x.T)
    return yt.T


def _local_conv(x_with_halo: jax.Array, ir: jax.Array) -> jax.Array:
    """Causal FIR of (T, halo+S_local) against shared IR (L,), valid part."""
    l = ir.shape[0]
    t = x_with_halo.shape[0]
    lhs = x_with_halo[None]
    rhs = jnp.broadcast_to(ir[::-1][None, None, :], (t, 1, l))
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), "VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=t,
        preferred_element_type=jnp.float32,
        # full f32 (no TF32): the registered benchmark gates at
        # rel-to-peak 1e-4 against a float64 NumPy reference
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


def make_suite_step(mesh: Mesh, n_micro: int = 2):
    """Build the jitted multi-device pipeline step.

    fn(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs) -> (T, S)
      x:            (T, S)   tracks dp-sharded, samples sp-sharded
      amp..s_im:    (M,)     modes tp-sharded
      ir:           (L,)     replicated FIR kernel (sp halo size = L-1)
      stage_coeffs: (K, 5)   biquad cascade, one stage per tp rank
    """
    dp = mesh.shape["dp"]
    tp = mesh.shape["tp"]
    sp = mesh.shape["sp"]

    biquad = _biquad_block

    def local_step(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs):
        # x local: (T/dp, S/sp); modes local: (M/tp,)
        t_local, s_local = x.shape
        l = ir.shape[0]

        # --- dp stage: gain + IIR per local tracks (time axis must be
        # whole for the recurrence: all-gather the sp shards, scan, keep
        # our slice). The gather runs along "sp".
        x_full = jax.lax.all_gather(x, "sp", axis=1, tiled=True)  # (T/dp, S)
        y_full = biquad(2.0 * x_full, stage_coeffs[0])

        # --- sp stage: halo-exchange FIR convolution on the sample axis.
        sp_idx = jax.lax.axis_index("sp")
        y_local = jax.lax.dynamic_slice_in_dim(
            y_full, sp_idx * s_local, s_local, axis=1
        )
        # ship each shard's last (L-1) samples to the right neighbor
        halo = jax.lax.ppermute(
            y_local[:, -(l - 1):] if l > 1 else y_local[:, :0],
            "sp",
            [(i, (i + 1) % sp) for i in range(sp)],
        )
        halo = jnp.where(sp_idx == 0, jnp.zeros_like(halo), halo)
        conv_out = _local_conv(jnp.concatenate([halo, y_local], axis=1), ir)

        # --- tp stage: partial modal bank + psum over "tp". Each sp
        # shard owns time slice [sp_idx*s_local, ...), so pre-rotate the
        # phasor states to this shard's start sample first.
        def pre_rotate(_, carry):
            re, im = carry
            return re * cos_w - im * sin_w, re * sin_w + im * cos_w

        s_re, s_im = jax.lax.fori_loop(
            0, sp_idx * s_local, pre_rotate, (s_re, s_im)
        )

        mix_local, _, _ = modal_bank_xla(
            amp, cos_w, sin_w, s_re, s_im, s_local, 32)
        mix = jax.lax.psum(mix_local, "tp")  # (32, S/sp)

        # mix into tracks by global track index % 32
        dp_idx = jax.lax.axis_index("dp")
        g_track = dp_idx * t_local + jnp.arange(t_local)
        mixed = conv_out + mix[g_track % 32, :]

        # --- pp stage: cascaded biquads pipelined over the "tp" axis.
        # Each stage's recurrence needs the whole sample axis, so gather
        # the sp shards first and re-slice after the cascade.
        mixed_full = jax.lax.all_gather(mixed, "sp", axis=1, tiled=True)
        s_full = mixed_full.shape[1]
        k_idx = jax.lax.axis_index("tp")
        micro_t = t_local // n_micro
        micro = mixed_full.reshape(n_micro, micro_t, s_full)
        buf = jnp.zeros((micro_t, s_full), mixed.dtype)
        out = jnp.zeros_like(micro)
        n_steps = n_micro + tp - 1
        for step_i in range(n_steps):
            inject = micro[step_i] if step_i < n_micro else jnp.zeros_like(buf)
            cur = jnp.where(k_idx == 0, inject, buf)
            cur = biquad(cur, stage_coeffs[k_idx])
            done_i = step_i - (tp - 1)
            if done_i >= 0:
                final = jnp.where(k_idx == tp - 1, cur, jnp.zeros_like(cur))
                out = out.at[done_i].set(final)
            buf = jax.lax.ppermute(
                cur, "tp", [(i, (i + 1) % tp) for i in range(tp)]
            )
        out = jax.lax.psum(out, "tp")  # only the last rank contributed
        out = out.reshape(t_local, s_full)
        return jax.lax.dynamic_slice_in_dim(
            out, sp_idx * s_local, s_local, axis=1
        )

    spec_x = P("dp", "sp")
    spec_modes = P("tp")
    spec_rep = P()
    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_x, spec_modes, spec_modes, spec_modes, spec_modes,
                  spec_modes, spec_rep, spec_rep),
        out_specs=spec_x,
        check_vma=False,
    )
    return jax.jit(fn)


@jax.jit
def single_device_step(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs):
    """The suite step's math on one device, with no mesh and no
    collectives: what a sharded run is compared with. The cascade runs
    every stage of ``stage_coeffs`` in series (one per tp rank when
    sharded)."""
    t, s = x.shape
    l = ir.shape[0]
    y = _biquad_block(2.0 * x, stage_coeffs[0])
    pad = jnp.concatenate([jnp.zeros((t, l - 1), x.dtype), y], axis=1)
    conv = _local_conv(pad, ir)
    mix, _, _ = modal_bank_xla(amp, cos_w, sin_w, s_re, s_im, s, 32)
    out = conv + mix[jnp.arange(t) % 32, :]
    for k in range(stage_coeffs.shape[0]):
        out = _biquad_block(out, stage_coeffs[k])
    return out


def suite_step_example_args(
    mesh: Mesh,
    tracks: int = 16,
    samples: int = 64,
    modes: int = 128,
    ir_len: int = 9,
    seed: int = 42,
) -> Tuple:
    """Tiny, mesh-compatible example inputs (sharded via device_put)."""
    dp = mesh.shape["dp"]
    tp = mesh.shape["tp"]
    sp = mesh.shape["sp"]
    tracks = max(tracks, 2 * dp * 2)  # >= 2 microbatches of >=1 track per shard
    tracks -= tracks % (dp * 2)
    samples = samples - samples % sp or sp
    modes = modes - modes % (tp * 32) or tp * 32

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, samples), dtype=np.float32) * 2 - 1).astype(np.float32)
    amp = g.random(modes, dtype=np.float32)
    freq = g.random(modes, dtype=np.float32) * 0.45
    w = 2 * np.pi * freq
    cos_w = np.cos(w).astype(np.float32)
    sin_w = np.sin(w).astype(np.float32)
    s_re = (g.random(modes, dtype=np.float32) * 2 - 1).astype(np.float32)
    s_im = (g.random(modes, dtype=np.float32) * 2 - 1).astype(np.float32)
    ir = np.zeros(ir_len, np.float32)
    ir[0] = 1.0
    ir[ir_len // 2] = 0.5
    n_stages = tp
    coeffs = np.stack(
        [
            np.array(
                biquad_lowpass_coefficients(0.05 + 0.04 * k), np.float32
            )
            for k in range(max(n_stages, 1))
        ]
    )

    put = functools.partial(jax.device_put)
    args = (
        put(x, NamedSharding(mesh, P("dp", "sp"))),
        put(amp, NamedSharding(mesh, P("tp"))),
        put(cos_w, NamedSharding(mesh, P("tp"))),
        put(sin_w, NamedSharding(mesh, P("tp"))),
        put(s_re, NamedSharding(mesh, P("tp"))),
        put(s_im, NamedSharding(mesh, P("tp"))),
        put(ir, NamedSharding(mesh, P())),
        put(jnp.asarray(coeffs), NamedSharding(mesh, P())),
    )
    return args
