"""Conv1D: direct time-domain FIR per track with per-track windowed-sinc
IRs (cuda/bench_conv1d.cu). IR length defaults to 1024 (bench_conv1d.cuh:
11); the IR bank lives HBM-resident across iterations (the texture-object
analog, bench_conv1d.cu:123-157). Output is track-major like CUDA.

Edge semantics: default "clamp" confines the IR window within each track
(the Metal/accel convention); "bleed" reproduces the CUDA kernel's
flat-buffer indexing where the window runs into the previous track's
tail (bench_conv1d.cu:20-22) -- a documented reference quirk
(SURVEY.md s7), selectable via --convEdgeMode.
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.models.common import StandardBufferBenchmark
from gpuaudiobench_jax.ops.conv import conv1d_direct
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import conv1d_impulse_responses

DEFAULT_IR_LENGTH = 1024  # bench_conv1d.cuh:11


def conv1d_reference(
    x: np.ndarray, ir: np.ndarray, edge_mode: str = "clamp"
) -> np.ndarray:
    """Float64 direct convolution golden (bench_conv1d.cu:188-208)."""
    t, s = x.shape
    l = ir.shape[1]
    out = np.empty((t, s), np.float64)
    x64 = x.astype(np.float64)
    ir64 = ir.astype(np.float64)
    if edge_mode == "bleed":
        # The window reaches at most L-1 samples into preceding tracks of
        # the flat buffer (bench_conv1d.cu:197-201), so prepend that tail.
        flat = np.concatenate([np.zeros(l - 1, np.float64), x64.ravel()])
        for track in range(t):
            base = track * s  # position in original flat signal
            seg = flat[base : base + (l - 1) + s]
            out[track] = np.convolve(seg, ir64[track])[l - 1 : l - 1 + s]
    else:
        for track in range(t):
            out[track] = np.convolve(x64[track], ir64[track])[:s]
    return out.astype(np.float32)


class Conv1DBenchmark(StandardBufferBenchmark):
    name = "Conv1D"
    tolerance = 1e-3  # bench_conv1d.cu:108

    def setup(self) -> None:
        self.ir_length = self.cfg.ir_length or DEFAULT_IR_LENGTH
        self.edge_mode = self.cfg.conv_edge_mode
        self.setup_standard_buffers()
        self.ir = conv1d_impulse_responses(self.track_count, self.ir_length)
        self._ir_dev = self.put_input(self.ir)  # per-track IR bank: dp-sharded
        self.golden = conv1d_reference(self.host_input, self.ir, self.edge_mode)
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        y = conv1d_direct(x, self._ir_dev, self.edge_mode)
        self.host_output = dev.from_device(y)

    def device_iterate(self) -> None:
        dev.block(conv1d_direct(self._resident_input, self._ir_dev,
                                self.edge_mode))

    def overlap_body(self):
        ir, em = self._ir_dev, self.edge_mode
        return (lambda x, c: (conv1d_direct(x, ir, em), c),
                self.overlap_blocks(), ())

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        # The IRs ride the barrier chain's carry rather than the
        # closure, which would embed trackCount*irLength floats in the
        # compiled module.
        return barrier_chain(
            lambda x, ir: conv1d_direct(x, ir, self.edge_mode),
            self._resident_input,
            self._ir_dev,
        )

    def cost_model(self):
        t, s, l = self.track_count, self.buffer_size, self.ir_length
        return {
            "flops": 2 * t * s * l,  # MAC per (sample, tap)
            "hbm_bytes": (2 * t * s + t * l) * 4,
            "unit": "fp32",
        }

    def metadata(self):
        return {"irLength": self.ir_length, "edgeMode": self.edge_mode}
