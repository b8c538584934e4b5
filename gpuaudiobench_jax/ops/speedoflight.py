"""Speed-of-light microbenchmark bodies: what the card really reaches,
reported beside its published peaks (utils/roofline.py).

* ``fma_chain``      -- f32 FMA throughput on the CUDA cores: k
                        dependent FMA passes per element, compute-bound
                        by construction (arithmetic intensity k/4
                        FLOP/byte).
* ``stream_scale``   -- device-memory bandwidth: one read + one write
                        pass over an array larger than the L2.
* ``matmul_bf16``    -- bf16 tensor-core product, f32 accumulation via
                        ``preferred_element_type``.
* ``matmul_tf32``    -- f32 operands at DEFAULT precision, which the GPU
                        runs in TF32 on the tensor cores.
* ``matmul_int8``    -- s8 x s8 -> s32 tensor-core product.

The FMA chain y <- y*m + c composed k times has the closed form
y = x*m^k + c*(1-m^k)/(1-m), so the kernel is exactly validatable like
every other benchmark. Floating-point non-associativity keeps XLA from
algebraically collapsing the chain (it only reassociates under explicit
fast-math opt-ins, which jit does not set).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# FMA chain constants. m pulls toward the fixed point c/(1-m) = 2, so
# values stay O(1) at any chain length (no overflow, no denormals).
FMA_M = 0.9995
FMA_C = 0.001
# Chains up to _FULL_UNROLL are fully unrolled into one fused
# elementwise kernel (no loop at all); longer chains run a fori_loop of
# _UNROLL-deep bodies.
_FULL_UNROLL = 512
_UNROLL = 128


def fma_golden(x, k: int):
    """Closed-form float64 golden: x*m^k + c*(1-m^k)/(1-m)."""
    import numpy as np

    m = np.float64(np.float32(FMA_M))
    c = np.float64(np.float32(FMA_C))
    mk = m**k
    return (np.asarray(x, np.float64) * mk + c * (1.0 - mk) / (1.0 - m)).astype(
        np.float32
    )


def _fma_body(y, steps: int):
    m = jnp.float32(FMA_M)
    c = jnp.float32(FMA_C)

    if steps <= _FULL_UNROLL:
        for _ in range(steps):
            y = y * m + c
        return y

    def body(_, y):
        for _ in range(_UNROLL):
            y = y * m + c
        return y

    whole, rem = divmod(steps, _UNROLL)
    y = jax.lax.fori_loop(0, whole, body, y) if whole else y
    for _ in range(rem):
        y = y * m + c
    return y


@functools.partial(jax.jit, static_argnames=("k",))
def fma_chain(x: jax.Array, k: int) -> jax.Array:
    return _fma_body(x, k)


@jax.jit
def stream_scale(x: jax.Array) -> jax.Array:
    """One full read + write pass: y = 2x. XLA fuses this into a single
    streaming kernel; no hand-written kernel needed to hit bandwidth."""
    return x * jnp.float32(2.0)


@jax.jit
def matmul_bf16(a: jax.Array, b: jax.Array) -> jax.Array:
    """bf16 x bf16 -> f32-accumulated matmul on the tensor cores."""
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


@jax.jit
def matmul_tf32(a: jax.Array, b: jax.Array) -> jax.Array:
    """f32 x f32 at DEFAULT precision: the GPU contracts it in TF32 on
    the tensor cores (10-bit mantissa operands, f32 accumulation)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.DEFAULT,
                   preferred_element_type=jnp.float32)


@jax.jit
def matmul_int8(a: jax.Array, b: jax.Array) -> jax.Array:
    """s8 x s8 -> s32-accumulated matmul: the tensor cores' integer
    rate (twice the bf16 rate on Hopper). Exact in int32 for the
    operand magnitudes the SOL benchmark feeds it (|sum| < 2^31)."""
    return jnp.dot(a, b, preferred_element_type=jnp.int32)
