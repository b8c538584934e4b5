"""Overlapped-infeed measurement: double-buffer host->HBM uploads
against device compute.

SURVEY.md §2.4 maps the reference's pipeline-parallel axis onto
"double-buffered infeed (overlap host transfer with compute)", and the
reference's poster names pipelining as the mitigation a developer
would add to a transfer-dominated deployment
(media/dafx24/index.html:328-331). Every other tier in
this harness is either fully serial (the round-trip iteration:
upload -> compute -> read, synchronized per block) or fully on-device
(the saturated scan: no per-block host traffic at all). The
steady-state a real DAW deployment runs -- upload block k+1 WHILE
block k computes -- sits between them and is what this module
measures (VERDICT r3 missing #2).

Mechanics: JAX dispatch is asynchronous, so pipelining needs no
threads -- the host enqueues ``compute(block k)`` then immediately
enqueues ``device_put(block k+1)``; the runtime is free to run the
DMA and the kernel concurrently. The loop holds TWO live device input
slots (the one computing and the one filling: classic double
buffering) and synchronizes ONCE at the end on the last block's probe
-- legal because one device executes dispatches in program order, so
the last compute finishing implies every predecessor finished.

The serial twin runs the same loop with a per-block probe sync, which
forces upload(k+1) to wait for compute(k); the sync costs about one
launch overhead per block, which the overlapped number's single sync
amortizes away, exactly like the saturated tier's.

State: stateful benchmarks carry their device-resident state through
the loop (block k+1's filter memory depends on block k -- the true
streaming dependency structure); only the INPUT upload is pipelined,
which is the point.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def _probe_slice(y):
    """1-element completion token for a block output (pytree-safe)."""
    import jax

    return jax.tree_util.tree_leaves(y)[0].ravel()[:1]


def measure_overlap(
    step_fn: Callable,
    host_blocks,
    carry,
    depth: int,
    reps: int = 5,
) -> Tuple[List[float], List[float]]:
    """(serial_ms, overlapped_ms) per-block wall latencies.

    ``step_fn(x_dev, carry) -> (y, carry')`` runs ONE block of device
    compute on an uploaded input block (jitted by the caller);
    ``host_blocks`` is a sequence of >= 2 DISTINCT host payload arrays
    cycled across blocks (with a single repeated buffer the per-block
    upload can be runtime-dedupable, silently inflating the overlapped
    speedup -- enforced here rather than trusted to each overlap_body,
    ADVICE r4); ``carry`` is the initial device-resident state pytree
    (an empty tuple for stateless blocks).
    """
    import numpy as np

    from gpuaudiobench_jax.utils import device as dev

    host_blocks = list(host_blocks)
    nh = len(host_blocks)
    if nh < 2:
        raise ValueError(
            "measure_overlap needs >= 2 distinct host blocks (a single "
            "repeated buffer makes the upload dedupable; see "
            "base.Benchmark.overlap_body)"
        )

    # Warm/compile outside any timing.
    c = carry
    xd = dev.to_device(host_blocks[0])
    y, c = step_fn(xd, c)
    _ = np.asarray(_probe_slice(y))

    serial: List[float] = []
    overlapped: List[float] = []
    for _ in range(max(1, reps)):
        # Serial: upload(k) -> compute(k) -> sync, then upload(k+1).
        t0 = time.perf_counter()
        for k in range(depth):
            xd = dev.to_device(host_blocks[k % nh])
            y, c = step_fn(xd, c)
            np.asarray(_probe_slice(y))
        serial.append((time.perf_counter() - t0) / depth * 1000.0)

        # Overlapped: enqueue compute(k), then upload(k+1) while it
        # runs; one sync at the end covers the whole pipeline.
        t0 = time.perf_counter()
        xd = dev.to_device(host_blocks[0])
        last = None
        for k in range(depth):
            y, c = step_fn(xd, c)
            if k + 1 < depth:
                xd = dev.to_device(host_blocks[(k + 1) % nh])
            last = y
        np.asarray(_probe_slice(last))
        overlapped.append((time.perf_counter() - t0) / depth * 1000.0)
    return serial, overlapped
