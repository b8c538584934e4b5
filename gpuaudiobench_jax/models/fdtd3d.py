"""FDTD3D: 3-D room acoustics, pressure-velocity staggered grid
(cuda/bench_fdtd3d.cu). 52^3 grid (50^3 room + boundary), c=343,
dx=0.01, rho=1.225, absorption 0.2, dt = 0.5*dx/(c*sqrt(3)), 3 FDTD
steps per audio sample (bench_fdtd3d.cuh:145-174). Per iteration the
full bufferSize x 3 step loop runs as ONE jitted program (vs CUDA's
512 x 3 kernel launches with per-sample device syncs).

Golden: a full NumPy CPU FDTD simulation (the Metal strategy,
FDTD3DBenchmark.swift:225-351 -- the strongest oracle in the reference;
the CUDA CPU ref is a documented amplitude-scaling fake,
bench_fdtd3d.cu:445-459). Tolerance 5e-3 (Metal's, vs CUDA's 1e-1
fake-ref tolerance).

Divergence (documented): field state is re-zeroed each iteration so
every iteration equals the golden pass; the reference lets fields evolve
across iterations while validating against a single-pass reference.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.ops import fdtd3d as op
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import generate_random_audio


def fdtd3d_reference(x: np.ndarray, steps_per_sample: int = op.STEPS_PER_SAMPLE,
                     receivers=None, n: int = op.GRID_N,
                     source: tuple = op.SOURCE,
                     receiver: tuple = op.RECEIVER):
    """Full float32 NumPy FDTD simulation (mirrors ops/fdtd3d.py update
    equations; the independent oracle for the fused device program).
    receivers: optional (xs, ys, zs) per-track arrays (WebGPU parity);
    None = the single broadcast receiver (CUDA/Metal)."""
    k1 = np.float32(op.DT_OVER_RHO_DX)
    k2 = np.float32(op.RHO_C2_DT_OVER_DX)
    absorb = np.float32(1.0 - op.ABSORPTION)
    p = np.zeros((n, n, n), np.float32)
    vx = np.zeros((n + 1, n, n), np.float32)
    vy = np.zeros((n, n + 1, n), np.float32)
    vz = np.zeros((n, n, n + 1), np.float32)

    idx = np.arange(n)
    edge = (idx == 0) | (idx == n - 1)
    boundary = edge[:, None, None] | edge[None, :, None] | edge[None, None, :]
    sx, sy, sz = source
    rx, ry, rz = receiver

    tracks, s = x.shape
    src = x.sum(axis=0, dtype=np.float32) * np.float32(op.SOURCE_SCALE)
    if receivers is None:
        rcv = np.zeros((1, s), np.float32)
    else:
        rcv = np.zeros((tracks, s), np.float32)
    for smp in range(s):
        p[sx, sy, sz] += src[smp]
        for _ in range(steps_per_sample):
            vx[1:n, :, :] -= k1 * (p[1:, :, :] - p[:-1, :, :])
            vy[:, 1:n, :] -= k1 * (p[:, 1:, :] - p[:, :-1, :])
            vz[:, :, 1:n] -= k1 * (p[:, :, 1:] - p[:, :, :-1])
            div = (
                (vx[1:, :, :] - vx[:-1, :, :])
                + (vy[:, 1:, :] - vy[:, :-1, :])
                + (vz[:, :, 1:] - vz[:, :, :-1])
            )
            p = np.where(boundary, p * absorb, p - k2 * div)
        if receivers is None:
            rcv[0, smp] = p[rx, ry, rz] * np.float32(op.OUTPUT_SCALE)
        else:
            xs, ys, zs = receivers
            rcv[:, smp] = p[xs, ys, zs] * np.float32(op.OUTPUT_SCALE)
    if receivers is None:
        return np.broadcast_to(rcv, (tracks, s)).copy()
    return rcv


class FDTD3DBenchmark(Benchmark):
    name = "FDTD3D"
    tolerance = 5e-3  # Metal full-sim tolerance (FDTD3DBenchmark.swift)

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)

    def setup(self) -> None:
        self.reject_data_parallel(
            "FDTD3D has no data-parallel axis (one shared acoustic "
            "field); multi-device FDTD uses domain decomposition -- see "
            "parallel/fdtd_sharded.py (tests/test_multichip.py)"
        )
        t, s = self.track_count, self.buffer_size
        self.host_input = generate_random_audio(t * s, self.cfg.seed).reshape(t, s)
        self._resident_input = dev.to_device(self.host_input)
        self._room = self.cfg.fdtd_room
        n = self._n = op.grid_n(self._room)
        self._source = op.source_pos(self._room)
        self._receiver = op.receiver_pos(self._room)
        self.track_alloc("pressureField", n * n * n * 4)
        self.track_alloc("velocityFields", 3 * (n + 1) * n * n * 4)
        self.track_alloc("ioBuffers", t * s * 4 * 4)
        self._receivers = None
        import functools

        if self.cfg.fdtd_per_track_receivers:
            # Per-track receiver cells (WebGPU parity).
            self._receivers = op.receiver_line(t, n)
            xs, ys, zs = self._receivers
            rcv_flat = dev.to_device(
                (xs.astype(np.int64) * n * n + ys * n + zs).astype(np.int32)
            )
            src = self._source
            self._block = lambda x, *fields: op.fdtd3d_block_multircv(
                x, *fields, rcv_flat, source=src
            )
        else:
            self._block = functools.partial(
                op.fdtd3d_block,
                source=self._source, receiver=self._receiver)
        self._zero_fields = tuple(
            dev.to_device(np.asarray(f)) for f in op.zero_fields(n))
        from gpuaudiobench_jax.utils.golden_cache import cached_golden

        self.golden = cached_golden(
            "fdtd3d",
            {
                "seed": self.cfg.seed, "tracks": t, "samples": s,
                "grid": n, "steps": op.STEPS_PER_SAMPLE,
                "src": list(self._source), "rcv": list(self._receiver),
                "perTrackRcv": bool(self.cfg.fdtd_per_track_receivers),
            },
            lambda: fdtd3d_reference(self.host_input,
                                     receivers=self._receivers, n=n,
                                     source=self._source,
                                     receiver=self._receiver),
        )
        self.host_output = None
        self.iterate()

    def iterate(self) -> None:
        x = dev.to_device(self.host_input)
        out, *_ = self._block(x, *self._zero_fields)
        self.host_output = dev.from_device(out)

    def device_iterate(self) -> None:
        out, *_ = self._block(self._resident_input, *self._zero_fields)
        dev.block(out)

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import probe

        block = self._block

        # The source block rides the carry (aliased, returned
        # unchanged), not the closure -- the module-embedding lesson
        # (models/iir.py stream_body).
        def step(carry):
            x, fields = carry
            out, *new_fields = block(x, *fields)
            return (x, tuple(new_fields)), probe(out)

        return step, (self._resident_input, self._zero_fields)

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        n, s = self._n, self.buffer_size
        cells = n ** 3
        substeps = s * op.STEPS_PER_SAMPLE
        fields_bytes = (cells + 3 * (n + 1) * n * n) * 4
        return {
            "flops": 20 * cells * substeps,  # 3x 2pt grads + 7pt div + scales
            # Fields read and written once per block (the floor if they
            # stayed on chip); a scan step that streams them through
            # device memory pays this once per substep instead.
            "hbm_bytes": 2 * fields_bytes + self.track_count * s * 4 * 2,
            "unit": "fp32",
        }

    def metadata(self):
        return {
            "room": self._room,
            "grid": [self._n] * 3,
            "stepsPerSample": op.STEPS_PER_SAMPLE,
            "soundSpeed": op.SOUND_SPEED,
            "spatialStep": op.SPATIAL_STEP,
            "timeStep": op.TIME_STEP,
            "absorption": op.ABSORPTION,
            "source": list(self._source),
            "receiver": "per-track line" if self._receivers is not None
                        else list(self._receiver),
        }
