"""Random memory access (granular synthesis): strided gather from a
512 MiB HBM-resident sample pool.

Equivalent of RndMemKernel (cuda/bench_rndmem.cu:7-20): per
track, copy bufferSize contiguous samples starting at that track's
playhead (random, unaligned), writing the output *interleaved*
(out[tracks*i + track], bench_rndmem.cu:18). Playheads advance host-side
between iterations with per-track loop wrap (bench_rndmem.cu:176-186).

The thread-per-track copy becomes a batched dynamic_slice (XLA gather)
over the pool; the pool stays resident in HBM across iterations exactly
like d_sample_memory.
"""

from __future__ import annotations

import jax


@jax.jit
def rndmem_gather(pool: jax.Array, playheads: jax.Array, out_template: jax.Array):
    """pool: (P,) float32; playheads: (T,) int32;
    out_template: (T, S) only for shape. Returns (S, T) interleaved."""
    s = out_template.shape[1]

    def one(ph):
        return jax.lax.dynamic_slice(pool, (ph,), (s,))

    rows = jax.vmap(one)(playheads)  # (T, S)
    return rows.T  # (S, T): flat layout == tracks*i + track
