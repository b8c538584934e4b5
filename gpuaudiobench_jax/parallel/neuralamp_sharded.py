"""Tensor-parallel NeuralAmp variants: the TCN's channel axis and the
LSTM's hidden axis distributed over a mesh axis.

The single-device NeuralAmp block (ops/neuralamp.py) holds all C
channels of every tap matrix and activation on one device; its walls
are matrix FLOPs (f32) or activation device-memory traffic (bf16). This
variant is the Megatron column-parallel pattern applied to the dilated
conv stack: each rank owns C/n output channels of every tap matrix (and
the matching slice of every activation/tail), so per layer

* each rank all-gathers the layer input's channel shards to the full
  (T, S+ctx, C) activation (the contraction needs every input channel);
* contracts it against its LOCAL (K, C, C/n) column shard -- 1/n of
  the layer's MACs -- and applies tanh + residual locally;
* the output 1x1 conv is a row-parallel contraction finished by one
  ``psum``.

Per layer per rank the wire cost is one all_gather of (T, (S+ctx), C)
floats; weights and carried tails never move. Activations dominate the
wire only when C is small relative to K*C^2/n MACs -- at the default
C=128, L=10 the FLOP:gathered-byte ratio is ~2*K*C/(4n) = 192/n
FLOP/B.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gpuaudiobench_jax.ops.neuralamp import (
    F32_GEMM_PRECISION,
    KERNEL,
)


def make_neuralamp_tp_block(mesh: Mesh, layers: int, axis: str = "tp"):
    """Returns jitted fn(x, tails, params) -> (y, tails') with the
    channel axis of every tap matrix, bias, and carried tail sharded
    over ``axis``; x and y replicated.

    Call with GLOBAL arrays shaped exactly like the single-device
    ops.neuralamp.tcn_block operands (f32 params from cast_params);
    equivalence against it is test-pinned (tests/test_neuralamp.py).
    """

    def local_block(x, tails, params):
        b = x.shape[1]
        hi = F32_GEMM_PRECISION  # match the single-chip f32 contract
        # Input 1x1 conv: w_in is channel-sharded, so h is born local.
        h = jnp.tanh(x[..., None] * params["w_in"] + params["b_in"])
        new_tails = []
        for l in range(layers):
            d = 1 << l
            ctx = (KERNEL - 1) * d
            ext = jnp.concatenate([tails[l], h], axis=1)
            new_tails.append(ext[:, -ctx:])
            # Contraction needs every input channel: gather the shards.
            full = jax.lax.all_gather(ext, axis, axis=2, tiled=True)
            acc = params[f"b{l}"]
            for j in range(KERNEL):
                acc = acc + jnp.einsum(
                    "tsc,cd->tsd", full[:, j * d:j * d + b],
                    params[f"w{l}"][j], precision=hi,
                    preferred_element_type=jnp.float32)
            h = h + jnp.tanh(acc)
        # Output 1x1 conv: row-parallel (w_out sharded on the
        # contraction axis), finished by one psum.
        y = jax.lax.psum(
            jnp.einsum("tsc,c->ts", h, params["w_out"], precision=hi,
                       preferred_element_type=jnp.float32), axis)
        return y + params["b_out"], tuple(new_tails)

    rep = P()
    chan = P(None, None, axis)  # (T, ctx, C): shard channels
    param_specs = {"w_in": P(axis), "b_in": P(axis),
                   "w_out": P(axis), "b_out": rep}
    for l in range(layers):
        param_specs[f"w{l}"] = P(None, None, axis)  # (K, C, C/n) columns
        param_specs[f"b{l}"] = P(axis)
    fn = shard_map(
        local_block, mesh=mesh,
        in_specs=(rep, tuple(chan for _ in range(layers)), param_specs),
        out_specs=(rep, tuple(chan for _ in range(layers))),
        check_vma=False,
    )
    return jax.jit(fn)


def make_neuralamp_lstm_tp_block(mesh: Mesh, axis: str = "tp"):
    """Hidden-sharded (tensor-parallel) NeuralAmpLSTM block.

    The single-chip LSTM (ops/neuralamp.py lstm_block) is a per-sample
    scan whose (T, H+1) x (H+1, 4H) gate GEMM is too small to fill the
    matrix units -- issue-bound sequential dispatch. Sharding the HIDDEN axis
    over ``axis`` gives each rank 1/n of the gate columns and of the
    carried (h, c), but the gate contraction needs the FULL previous h,
    so every sample pays one ``all_gather`` of the (T, H/n) hidden
    shards INSIDE the scan: B sequential latency-bound collectives per
    block, serialized by the recurrence. That is the regime this
    variant exists to measure -- the link-latency wall of recurrent
    inference, the sequential counterpart to the TCN variant's
    bandwidth-priced per-layer gathers (at T=128, H=128 each gather is
    64 KiB, so per-hop latency, not bytes, dominates).

    The dense output is row-parallel: each rank contracts its h shard
    against its w_out slice inside the scan and ONE (T, B) psum after
    the scan finishes the block -- the output collective does not ride
    the recurrence.

    Call with GLOBAL arrays shaped exactly like the single-device
    ``lstm_block`` operands (f32 params from cast_lstm_params; gate
    order i, f, g, o in contiguous H-blocks); equivalence against it is
    test-pinned (tests/test_neuralamp.py).
    """

    def local_block(x, h, c, params):
        hi = F32_GEMM_PRECISION  # match the single-chip f32 contract
        f32 = jnp.float32
        # Local shapes: h, c (T, H/n); w4 (H+1, 4, H/n); b4 (4, H/n);
        # w_out (H/n,).
        w4, b4 = params["w"], params["b"]
        w_out, b_out = params["w_out"], params["b_out"]
        dot = functools.partial(
            jnp.einsum, precision=hi, preferred_element_type=f32)

        def step(carry, x_t):
            h, c = carry
            # The gate GEMM needs every hidden unit of h_{t-1}: gather
            # the shards. This is the per-sample wire cost.
            h_full = jax.lax.all_gather(h, axis, axis=1, tiled=True)
            inp = jnp.concatenate([x_t[:, None], h_full], axis=1)
            z = dot("th,hgj->tgj", inp, w4) + b4
            i = jax.nn.sigmoid(z[:, 0])
            f = jax.nn.sigmoid(z[:, 1])
            g = jnp.tanh(z[:, 2])
            o = jax.nn.sigmoid(z[:, 3])
            c = f * c + i * g
            h = o * jnp.tanh(c)
            y_t = dot("tj,j->t", h, w_out)  # partial: finished by psum
            return (h, c), y_t

        (h, c), ys = jax.lax.scan(step, (h, c), x.T, unroll=8)
        y = jax.lax.psum(ys.T, axis) + b_out + x  # input skip
        return y, h, c

    rep = P()
    hid = P(None, axis)  # (T, H/n)
    param_specs = {
        "w": P(None, None, axis),  # (H+1, 4, H/n) column shards
        "b": P(None, axis),        # (4, H/n)
        "w_out": P(axis),
        "b_out": rep,
    }
    smapped = shard_map(
        local_block, mesh=mesh,
        in_specs=(rep, hid, hid, param_specs),
        out_specs=(rep, hid, hid),
        check_vma=False,
    )

    def fn(x, h, c, params):
        hidden = h.shape[1]
        # Regroup the (H+1, 4H) gate matrix to (H+1, 4, H) so the
        # PartitionSpec shards hidden UNITS (keeping each unit's four
        # gate columns co-resident) rather than whole gate blocks.
        p2 = dict(params)
        p2["w"] = params["w"].reshape(hidden + 1, 4, hidden)
        p2["b"] = params["b"].reshape(4, hidden)
        return smapped(x, h, c, p2)

    return jax.jit(fn)
