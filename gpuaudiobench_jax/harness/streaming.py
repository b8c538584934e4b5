"""Saturated/streaming measurement: N blocks per executable.

The reference's timed iteration (cuda/bench_base.cu:59-118) measures one
host->device->kernel->host round trip. The analog of the device's
steady-state capability is the *marginal* per-block cost with the
dispatch pipeline kept full: a ``lax.scan`` of ``--pipelineDepth``
blocks inside ONE executable, with state carried where the benchmark
has it (IIR z, DWG rails, modal phasors, FDTD fields, RndMem
playheads).

Stateless block bodies are chained through
``jax.lax.optimization_barrier`` so XLA cannot hoist the loop-invariant
block out of the scan (it would otherwise compute one block and
broadcast it -- a fake saturated number). Each step also emits a tiny
probe slice of its output which the scan stacks, so no block can be
dead-code-eliminated.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def probe(y) -> "jax.Array":  # noqa: F821 - lazy jax import
    """Tiny per-block residue: mean |value| of the (possibly pytree)
    output block, shape (1,).

    The scan stacks these, keeping every output element live (a single
    fused reduction per block -- negligible next to any workload) and
    giving soaks a state-integrity signal that tracks the WHOLE block.
    An earlier version sliced element [0] instead; for DWG that sample
    is structurally zero (at n=0 the walk position 0 never equals the
    3L/4 output tap), which read as a dead probe on a live string.
    """
    import jax
    import jax.numpy as jnp

    leaves = jax.tree_util.tree_leaves(y)
    return jnp.mean(jnp.abs(leaves[0])).reshape(1)


def slice_probe(y) -> "jax.Array":  # noqa: F821 - lazy jax import
    """1-element residue for streams whose liveness is already forced.

    ``barrier_chain`` routes the whole output block through
    ``optimization_barrier`` (its operands cannot be dead-code-
    eliminated while any result is live, and the carried result feeds
    the next block), so the probe there is only a stacking token --
    it does not need to touch the block. The whole-block ``probe``
    reduction is real extra work on that tier: a full read of the
    output block (10 MiB on LinkBandwidth) per chained block. Stateful
    streams keep ``probe``: there the mean
    is the soak-integrity signal, and output blocks are audio-sized.
    """
    import jax

    return jax.tree_util.tree_leaves(y)[0].ravel()[:1]


def barrier_chain(fn: Callable, *inputs) -> Tuple[Callable, tuple]:
    """``stream_body`` helper for STATELESS blocks.

    Carries the inputs themselves and ties the next block's inputs to
    the previous block's output via ``optimization_barrier``, forcing
    sequential execution of identical blocks. The probe is a 1-element
    slice, not the whole-block mean -- see ``slice_probe`` for why
    that is both safe (the barrier forces full materialization) and
    necessary (the mean is measurement tax on MiB-scale outputs).
    """
    import jax

    def step(carry):
        y = fn(*carry)
        carry2, y2 = jax.lax.optimization_barrier((carry, y))
        return carry2, slice_probe(y2)

    return step, tuple(inputs)


def measure_saturated(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
) -> List[float]:
    """Per-block wall latencies (ms) over ``reps`` runs of a
    ``depth``-block chained executable.

    Synchronization is a REAL device-to-host read of the stacked probes
    (depth elements): data cannot arrive before the computation
    finishes. The read is one fixed transfer, amortized across the
    depth like the dispatch overhead it sits next to.
    """
    import jax
    import numpy as np

    @jax.jit
    def chained(c):
        def f(c, _):
            return step_fn(c)

        c, probes = jax.lax.scan(f, c, None, length=depth)
        return probes

    _ = np.asarray(chained(carry))  # compile + warm

    latencies = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        np.asarray(chained(carry))
        latencies.append((time.perf_counter() - t0) / depth * 1000.0)
    return latencies


def measure_saturated_marginal(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
    lo_depth: int = 0,
) -> Tuple[List[float], List[float], int]:
    """Amortized AND marginal per-block cost from one interleaved
    two-depth measurement: ``(amortized_ms, marginal_ms, lo_depth)``.

    * ``amortized_ms[i]`` = wall(depth)/depth for rep i -- the wall per
      block of one full-depth chained executable. It INCLUDES the
      fixed dispatch + readback cost divided by the depth: for
      µs-scale bodies that share is not small.
    * ``marginal_ms[i]`` = (wall(depth) - wall(lo_depth)) /
      (depth - lo_depth) for rep i -- the device's marginal per-block
      cost with every depth-independent cost (dispatch, probe-read
      sync, pipeline fill) cancelled exactly. This is the number
      ``blocks_per_sec`` should be derived from.

    Reps are interleaved across the two depths (measure_saturated_multi)
    so drift cancels in the difference. Per-rep marginals of sub-noise
    bodies can go slightly negative (two ~equal walls differenced);
    they are reported raw -- consumers take the median over reps and
    clamp at 0 for reciprocal-throughput derivation.
    """
    lo = lo_depth or max(1, depth // 4)
    if lo >= depth:
        raise ValueError(f"lo_depth ({lo}) must be < depth ({depth})")
    per_lo, per_hi = measure_saturated_multi(
        step_fn, carry, [lo, depth], reps
    )
    marginal = [
        (h * depth - l * lo) / (depth - lo)
        for l, h in zip(per_lo, per_hi)
    ]
    return per_hi, marginal, lo


def measure_saturated_multi(
    step_fn: Callable,
    carry,
    depths: List[int],
    reps: int = 5,
) -> List[List[float]]:
    """Per-block wall latencies (ms) for SEVERAL pipeline depths,
    timed round-robin WITHIN each rep (d1, d2, d1, d2, ...).

    Interleaving keeps the paired depths contemporaneous so that
    clock-frequency or thermal drift over the measurement window
    cancels in depth-differencing consumers (measure_saturated_marginal);
    two back-to-back single-depth campaigns would not cancel drift.
    Returns one latency list per depth, same order as ``depths``.
    """
    import jax
    import numpy as np

    def make_chained(depth):
        @jax.jit
        def chained(c):
            def f(c, _):
                return step_fn(c)

            c, probes = jax.lax.scan(f, c, None, length=depth)
            return probes

        return chained

    chains = [make_chained(d) for d in depths]
    for ch in chains:  # compile + warm all depths before any timing
        _ = np.asarray(ch(carry))

    out: List[List[float]] = [[] for _ in depths]
    for _ in range(max(1, reps)):
        for i, (ch, d) in enumerate(zip(chains, depths)):
            t0 = time.perf_counter()
            np.asarray(ch(carry))
            out[i].append((time.perf_counter() - t0) / d * 1000.0)
    return out
