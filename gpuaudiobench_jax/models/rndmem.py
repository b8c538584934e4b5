"""RndMemRead: granular-synthesis random-memory stress
(cuda/bench_rndmem.cu). A 512 MiB uniform[0,1) sample pool stays
HBM-resident from setup (the d_sample_memory analog); per iteration,
each track copies bufferSize contiguous samples from its playhead into
an *interleaved* output (out[tracks*i + track]). Playheads advance
host-side by bufferSize with per-track loop wrap between start and
start + loopLen (loop lengths 1000-48000, bench_rndmem.cu:151-186).

Validation compares the last iteration's output against a golden
gathered with the playheads that iteration actually used (the reference
computes its golden from the *initial* playheads while playheads move
every iteration, bench_rndmem.cu:188-205 -- a time-dependent check;
documented divergence). Exact tolerance 1e-6 (bench_rndmem.cu:106).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.ops.rndmem import rndmem_gather
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import generate_uniform01


class RndMemBenchmark(Benchmark):
    name = "RndMemRead"
    tolerance = 1e-6  # bench_rndmem.cu:106

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)
        self.pool_elems = cfg.rndmem_pool_mb * 1024 * 1024 // 4
        self.sample_buffer_end = self.pool_elems - cfg.buffer_size

    def setup(self) -> None:
        t = self.track_count
        self.setup_sharding(t)
        self.host_pool = generate_uniform01(self.pool_elems, self.cfg.seed)
        # One-time 512 MiB upload; every window stays inside the pool
        # (ph + bufferSize <= pool_elems).
        self._pool_dev = self.put_replicated(self.host_pool)
        self.track_alloc("samplePool", self.host_pool.nbytes * 2)  # host+device
        self.track_alloc("outputBuffer", t * self.buffer_size * 4 * 2)
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        starts = g.integers(0, self.sample_buffer_end, t)
        loop_lens = self.cfg.rndmem_min_loop + g.integers(
            0, self.cfg.rndmem_max_loop - self.cfg.rndmem_min_loop, t
        )
        ends = np.minimum(starts + loop_lens, self.sample_buffer_end - 1)
        self.playheads_start = starts.astype(np.int64)
        self.playheads_end = ends.astype(np.int64)
        self.playheads = starts.astype(np.int32)
        self.last_playheads = self.playheads.copy()
        self._out_template = self.put_sharded(
            np.zeros((t, self.buffer_size), np.float32)
        )
        self.host_output = None
        self._gather = rndmem_gather
        self.iterate()

    def iterate(self) -> None:
        ph = self.put_sharded(self.playheads)
        out = self._gather(self._pool_dev, ph, self._out_template)
        self.host_output = dev.from_device(out).ravel()  # (S,T) flat interleaved
        self.last_playheads = self.playheads.copy()
        self._update_playheads()

    def overlap_body(self):
        """Per-block host traffic here is the PLAYHEAD array (the
        reference advances playheads host-side every iteration,
        bench_rndmem.cu:176-186); overlap uploads block k+1's
        playheads while block k's gather runs."""
        gather, pool, tmpl = self._gather, self._pool_dev, self._out_template
        ph1 = self.playheads.copy()
        ph2 = self.playheads.astype(np.int64) + self.buffer_size
        ph2 = np.where(ph2 >= self.playheads_end, self.playheads_start,
                       ph2).astype(self.playheads.dtype)
        return (lambda ph, c: (gather(pool, ph, tmpl), c),
                [ph1, ph2], ())

    def _update_playheads(self) -> None:
        """Host-side playhead advance with loop wrap (bench_rndmem.cu:176-186)."""
        ph = self.playheads.astype(np.int64) + self.buffer_size
        wrapped = np.where(ph >= self.playheads_end, self.playheads_start, ph)
        self.playheads = wrapped.astype(np.int32)

    def device_iterate(self) -> None:
        ph = self.put_sharded(self.playheads)
        dev.block(self._gather(self._pool_dev, ph, self._out_template))

    def stream_body(self):
        import jax.numpy as jnp

        from gpuaudiobench_jax.harness.streaming import probe

        tmpl, gather = self._out_template, self._gather
        starts = self.put_sharded(self.playheads_start.astype(np.int32))
        ends = self.put_sharded(self.playheads_end.astype(np.int32))
        s = self.buffer_size

        # The 512 MiB pool AND the per-track loop bounds ride in the
        # carry: a closure capture would be serialized into the
        # compiled module instead of staying a runtime argument -- the
        # bounds alone are 8 B/track.
        def step(carry):
            pool, st, en, ph = carry
            out = gather(pool, ph, tmpl)
            ph2 = ph + s
            ph2 = jnp.where(ph2 >= en, st, ph2)  # _update_playheads
            return (pool, st, en, ph2), probe(out)

        return step, (self._pool_dev, starts, ends,
                      self.put_sharded(self.playheads))

    def validate(self) -> ValidationData:
        t, s = self.track_count, self.buffer_size
        idx = self.last_playheads[:, None].astype(np.int64) + np.arange(s)[None, :]
        golden = self.host_pool[idx].T.ravel()  # (S,T) interleaved
        return compare_abs(
            self.host_output, golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        n = self.track_count * self.buffer_size
        return {
            "flops": 0,
            "hbm_bytes": 2 * n * 4,  # random-offset reads + writes
            "unit": "fp32",
            "note": "random unaligned reads from a 512 MiB pool",
        }

    def metadata(self):
        return {
            "poolMiB": self.cfg.rndmem_pool_mb,
            "minLoopLen": self.cfg.rndmem_min_loop,
            "maxLoopLen": self.cfg.rndmem_max_loop,
        }

