"""Registered multi-device benchmarks (extension; SURVEY.md §2.4).

The reference is single-device; these two benchmarks make the
multi-device layer a first-class, CLI-runnable workload instead of a
test-only module:

* ``MultiChipSuite`` -- the full sharded audio pipeline from
  parallel/multichip.py (dp tracks + tp modes/psum + sp samples/halo
  ppermute + pp cascade) over a ``--mesh dp,tp,sp`` device mesh, run as
  ONE jitted SPMD program and validated for exact equivalence against
  the same program on a trivial 1x1x1 mesh (collectives vs local math).

* ``LinkBandwidth`` -- interconnect micro-benchmark: a ring ppermute of
  ``--transferMiB`` MiB per device plus an all-reduce over every device
  (the device-to-device analog of the datacopy* host-link benchmarks).
  Validates the permutation and the reduction element-exactly.

Both run degenerately (single member per axis) on one device so the
full ``--benchmarkFilter /./`` suite stays green on single-device rigs;
on a mesh they exercise real collectives (NVLink between GPUs).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs, compare_rel
from gpuaudiobench_jax.utils import device as dev


def suite_reference(x, amp, cos_w, sin_w, s_re, s_im, ir, stage_coeffs,
                    n_stages: int):
    """Float32 NumPy reference for the logical multi-device pipeline
    (parallel/multichip.py make_suite_step): gain -> biquad(stage 0) ->
    causal FIR -> + modal mix (track % 32) -> n_stages-deep cascade.
    The cascade depth equals the tp extent (one stage per rank)."""
    def biquad(sig, c):
        b0, b1, b2, a1, a2 = (np.float32(v) for v in c)
        z1 = np.zeros(sig.shape[0], np.float32)
        z2 = np.zeros(sig.shape[0], np.float32)
        out = np.empty_like(sig)
        for n in range(sig.shape[1]):
            w = sig[:, n] - a1 * z1 - a2 * z2
            out[:, n] = b0 * w + b1 * z1 + b2 * z2
            z2, z1 = z1, w
        return out

    t, s = x.shape
    y = biquad((np.float32(2.0) * x).astype(np.float32), stage_coeffs[0])
    conv = np.empty_like(y)
    for tr in range(t):
        conv[tr] = np.convolve(
            y[tr].astype(np.float64), ir.astype(np.float64)
        )[:s].astype(np.float32)

    re, im = s_re.astype(np.float32).copy(), s_im.astype(np.float32).copy()
    mix = np.empty((32, s), np.float32)
    for n in range(s):
        re, im = re * cos_w - im * sin_w, re * sin_w + im * cos_w
        mix[:, n] = (amp * re).reshape(-1, 32).sum(axis=0)

    mixed = conv + mix[np.arange(t) % 32, :]
    for k in range(n_stages):
        mixed = biquad(mixed, stage_coeffs[k])
    return mixed


def parse_mesh(spec: str):
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) != 3 or not all(p.isdigit() and int(p) >= 1 for p in parts):
        raise ValueError(
            f"--mesh expects 'dp,tp,sp' positive integers, got {spec!r}"
        )
    return tuple(int(p) for p in parts)


def build_mesh(shape, axis_names):
    import jax

    n = int(np.prod(shape))
    devices = jax.devices()
    if len(devices) < n:
        raise ValueError(
            f"--mesh {'x'.join(map(str, shape))} needs {n} devices; "
            f"{len(devices)} available"
        )
    from jax.sharding import Mesh

    return Mesh(np.asarray(devices[:n]).reshape(shape), axis_names)


class MultiChipSuiteBenchmark(Benchmark):
    name = "MultiChipSuite"
    tolerance = 1e-4  # relative-to-peak vs the 1x1x1-mesh reference

    def setup(self) -> None:
        self.reject_data_parallel(
            "MultiChipSuite parallelism is set with --mesh dp,tp,sp, "
            "not --dataParallel"
        )
        from gpuaudiobench_jax.parallel.multichip import (
            make_suite_step,
            suite_step_example_args,
        )

        shape = parse_mesh(self.cfg.mesh)
        self.mesh_shape = shape
        self.mesh = build_mesh(shape, ("dp", "tp", "sp"))
        # Mode count kept modest by default: the suite step measures the
        # sharded pipeline + collectives, not peak modal throughput.
        modes = self.cfg.modal_num_modes or min(32 * self.track_count, 32768)
        tp = shape[1]
        if modes % (32 * tp) != 0:
            raise ValueError(
                f"MultiChipSuite needs --modalModes divisible by 32*tp "
                f"({32 * tp} for --mesh tp={tp}); got {modes}"
            )
        # The sp halo exchange ships the IR tail (L-1 samples) to the
        # right neighbor; the tail must fit inside one sample shard.
        ir_len = max(3, min(self.cfg.ir_length or 33,
                            self.buffer_size // shape[2]))
        self._ir_len = ir_len
        self._args = suite_step_example_args(
            self.mesh,
            tracks=self.track_count,
            samples=self.buffer_size,
            modes=modes,
            ir_len=ir_len,
            seed=self.cfg.seed,
        )
        # The sp halo ships L-1 samples; each sample shard must hold at
        # least that many or the VALID conv collapses to zero width.
        s_local = self._args[0].shape[1] // shape[2]
        if s_local < ir_len:
            raise ValueError(
                f"MultiChipSuite: per-shard sample count {s_local} "
                f"(bufferSize {self.buffer_size} over sp={shape[2]}) is "
                f"smaller than the FIR length {ir_len}; use a larger "
                "--bufferSize, smaller sp, or shorter --irLength"
            )
        self._step = make_suite_step(self.mesh)
        self.track_alloc(
            "pipelineBuffers",
            sum(int(np.prod(a.shape)) * 4 for a in self._args),
        )

        # Golden: an independent NumPy implementation of the logical
        # pipeline (the cascade depth equals tp, one stage per rank) --
        # the collectives/shardings must reproduce the plain sequential
        # math exactly up to f32 reassociation.
        self.golden = suite_reference(
            *(np.asarray(a) for a in self._args), n_stages=shape[1]
        )
        self.host_output = None
        self.iterate()

    def iterate(self) -> None:
        self.host_output = dev.from_device(self._step(*self._args))

    def device_iterate(self) -> None:
        dev.block(self._step(*self._args))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(self._step, *self._args)

    def validate(self) -> ValidationData:
        floor = float(np.abs(self.golden).max())
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        # Use the ACTUAL mesh-trimmed shapes (suite_step_example_args
        # may trim tracks/samples; metadata records them) so roofline
        # flops describe the work really done.
        x = self._args[0]
        t, s = x.shape
        modes = self._args[1].shape[0]
        tp = self.mesh_shape[1]
        flops = (
            9 * t * s              # input biquad
            + 2 * t * s * self._ir_len  # FIR
            + 8 * modes * s        # modal bank
            + 9 * tp * t * s       # cascade (tp stages)
        )
        return {
            "flops": flops,
            "hbm_bytes": 2 * int(np.prod(x.shape)) * 4 + 6 * modes * 4,
            "unit": "fp32",
            "note": f"SPMD over mesh {self.mesh_shape}",
        }

    def metadata(self):
        md = {
            "mesh": {"dp": self.mesh_shape[0], "tp": self.mesh_shape[1],
                     "sp": self.mesh_shape[2]},
            "modes": int(self._args[1].shape[0]),
            "tracks": int(self._args[0].shape[0]),
            "samples": int(self._args[0].shape[1]),
        }
        return md


class LinkBandwidthBenchmark(Benchmark):
    name = "LinkBandwidth"
    tolerance = 0.0  # exact

    def setup(self) -> None:
        self.reject_data_parallel(
            "LinkBandwidth spans all --mesh devices; --dataParallel "
            "does not apply"
        )
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        shape = parse_mesh(self.cfg.mesh)
        self.n_devices = int(np.prod(shape))
        mesh = build_mesh((self.n_devices,), ("dev",))
        self.chunk_elems = self.cfg.transfer_mib * 1024 * 1024 // 4
        n = self.n_devices

        def local(x):
            # ring shift: every device ships its chunk to the right
            # neighbor (one full bidirectional-link hop in parallel),
            # then an all-reduce of the per-device sums.
            shifted = jax.lax.ppermute(
                x, "dev", [(i, (i + 1) % n) for i in range(n)]
            )
            total = jax.lax.psum(jnp.sum(x, axis=1, keepdims=True), "dev")
            return shifted, total

        self._step = jax.jit(
            shard_map(
                local, mesh=mesh,
                in_specs=P("dev"), out_specs=(P("dev"), P("dev")),
                check_vma=False,
            )
        )
        g = np.random.Generator(np.random.MT19937(self.cfg.seed))
        self.host_input = g.random(
            (n, self.chunk_elems), dtype=np.float32
        )
        self._x = jax.device_put(
            self.host_input, NamedSharding(mesh, P("dev"))
        )
        self.track_alloc("chunks", self.host_input.nbytes * 2)
        self.host_output = None
        self.host_total = None
        self.iterate()

    def iterate(self) -> None:
        shifted, total = self._step(self._x)
        self.host_output = dev.from_device(shifted)
        self.host_total = dev.from_device(total)

    def device_iterate(self) -> None:
        dev.block(self._step(self._x))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(self._step, self._x)

    def validate(self) -> ValidationData:
        golden = np.roll(self.host_input, 1, axis=0)  # ring shift
        v = compare_abs(
            self.host_output, golden, 1e-6,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=f"{self.name} ppermute",
        )
        expect_total = np.full(
            (self.n_devices, 1),
            self.host_input.astype(np.float64).sum(),
            np.float32,
        )
        # f32 summation error is reduction-order dependent and grows
        # ~sqrt(n); a fixed 1e-6 already had only ~3x margin at the
        # default 10 MiB chunk and would flake at --transferMiB 1024.
        n_sum = self.n_devices * self.chunk_elems
        sum_tol = max(1e-6, 16.0 * float(np.sqrt(n_sum)) * 2.0 ** -24)
        v.merge_failure(
            compare_rel(
                self.host_total, expect_total, sum_tol,
                mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
                label=f"{self.name} psum",
            )
        )
        return v

    def total_elements(self) -> int:
        return self.n_devices * self.chunk_elems

    def bytes_processed(self) -> int:
        # bytes crossing the links: one chunk per device per direction
        return 2 * self.n_devices * self.chunk_elems * 4

    def cost_model(self):
        return {
            "flops": self.total_elements(),  # the reduce
            "hbm_bytes": 2 * self.total_elements() * 4,
            "unit": "fp32",
            "note": "ring hop + all-reduce; GB/s = bytes/device_ms",
        }

    def metadata(self):
        md = {
            "devices": self.n_devices,
            "chunkMiB": self.cfg.transfer_mib,
            "collectives": ["ppermute(ring)", "psum"],
        }
        return md
