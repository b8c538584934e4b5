"""speedoflight category: what the card reaches, beside its peaks.

Five microbenchmarks: an f32 FMA chain on the CUDA cores, a
device-memory stream (read + write), and bf16 / TF32 / int8 tensor-core
matrix products. They run through the exact same harness as every
workload benchmark (warmup, timed round trips, device timing,
saturated pass, validation against a closed-form or BLAS golden), and
their roofline shares are taken against the published peaks of
utils/roofline.py, so the gap between a published and a reached peak is
read off the same table.

Reference analog: the raw GB/s throughput fields of
cuda/bench_base.cu:110-115.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import (
    ValidationData,
    compare_abs,
    compare_rel,
)
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import generate_random_audio

_WIDTH = 1024  # row width of the 2D working sets


class _SolBenchmark(Benchmark):
    """Shared scaffolding: single-device microbenchmarks (peaks are
    per-device quantities; --dataParallel is rejected, not ignored)."""

    def __init__(self, cfg: BenchConfig):
        super().__init__(cfg)
        self.host_output = None
        self.golden = None

    def _reject_dp(self) -> None:
        self.reject_data_parallel(
            f"{self.name} measures single-device peaks; --dataParallel "
            "does not apply (use LinkBandwidth for the interconnect)"
        )

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )


class SolFmaBenchmark(_SolBenchmark):
    """f32 FMA throughput: k chained y = y*m + c passes per element
    (ops/speedoflight.fma_chain), one fused elementwise kernel.
    Validated against the closed form x*m^k + c*(1-m^k)/(1-m)."""

    name = "SOL_FMA_f32"
    # One f32 rounding per FMA accumulates ~k*eps on O(1) values.
    tolerance = 5e-4

    def setup(self) -> None:
        self._reject_dp()
        from gpuaudiobench_jax.ops.speedoflight import fma_chain, fma_golden

        self.k = self.cfg.sol_fma_k
        rows = max(8, self.cfg.sol_fma_mib * (1024 * 1024 // 4) // _WIDTH)
        self.host_input = generate_random_audio(
            rows * _WIDTH, self.cfg.seed
        ).reshape(rows, _WIDTH)
        self._resident = dev.to_device(self.host_input)
        self.golden = fma_golden(self.host_input, self.k)
        self.track_alloc("fmaBuffer", self.host_input.nbytes * 2)
        self._fn = fma_chain
        self.iterate()

    def iterate(self) -> None:
        x = dev.to_device(self.host_input)
        self.host_output = dev.from_device(self._fn(x, self.k))

    def device_iterate(self) -> None:
        dev.block(self._fn(self._resident, self.k))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        fn, k = self._fn, self.k
        return barrier_chain(lambda x: fn(x, k), self._resident)

    def total_elements(self) -> int:
        return self.host_input.size

    def bytes_processed(self) -> int:
        return self.host_input.nbytes * 2

    def cost_model(self):
        n = self.host_input.size
        return {
            "flops": 2 * self.k * n,
            "hbm_bytes": 2 * n * 4,
            "unit": "fp32",
            "note": f"FMA chain k={self.k}",
        }

    def metadata(self) -> Dict[str, Any]:
        return {"fmaK": self.k, "workingSetMiB": self.cfg.sol_fma_mib}


class SolHbmStreamBenchmark(_SolBenchmark):
    """Device-memory bandwidth: one read + one write pass (y = 2x) over
    an array larger than the L2 (ops/speedoflight.stream_scale)."""

    name = "SOL_HBM"
    tolerance = 0.0  # 2x is exact in f32

    def setup(self) -> None:
        self._reject_dp()
        rows = max(8, self.cfg.sol_stream_mib * (1024 * 1024 // 4) // _WIDTH)
        self.host_input = generate_random_audio(
            rows * _WIDTH, self.cfg.seed
        ).reshape(rows, _WIDTH)
        self._resident = dev.to_device(self.host_input)
        self.golden = (self.host_input * np.float32(2.0)).astype(np.float32)
        self.track_alloc("streamBuffer", self.host_input.nbytes * 2)
        self.iterate()

    def iterate(self) -> None:
        from gpuaudiobench_jax.ops.speedoflight import stream_scale

        x = dev.to_device(self.host_input)
        self.host_output = dev.from_device(stream_scale(x))

    def device_iterate(self) -> None:
        from gpuaudiobench_jax.ops.speedoflight import stream_scale

        dev.block(stream_scale(self._resident))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain
        from gpuaudiobench_jax.ops.speedoflight import stream_scale

        return barrier_chain(stream_scale, self._resident)

    def total_elements(self) -> int:
        return self.host_input.size

    def bytes_processed(self) -> int:
        return self.host_input.nbytes * 2

    def cost_model(self):
        n = self.host_input.size
        return {
            "flops": n,
            "hbm_bytes": 2 * n * 4,
            "unit": "fp32",
            "note": "read+write stream",
        }

    def metadata(self) -> Dict[str, Any]:
        return {"streamMiB": self.cfg.sol_stream_mib}


class SolMmaBenchmark(_SolBenchmark):
    """Tensor-core matmul throughput, d x d x d square
    (ops/speedoflight matmul_bf16 / matmul_tf32 / matmul_int8)."""

    def __init__(self, cfg: BenchConfig, dtype: str):
        super().__init__(cfg)
        self.dtype = dtype
        self.name = f"SOL_MMA_{dtype}"
        # bf16 inputs: products are exact in f32, so the only error is
        # the tensor cores' f32 accumulation over d terms -- an absolute
        # error at the scale of the partial sums: 4.9e-6 of the largest
        # output on an H100 at d = 4096 against a float64 golden (PERF.md).
        # 2^-16 of the largest output keeps 3x margin and still fails a
        # result rounded to bf16 (2^-9). int8 is EXACT (s32 accumulation never rounds and never
        # overflows at |operands| <= 127, d <= 4096: |sum| < 2^31).
        # tf32 rounds each operand to a 10-bit mantissa (<= 2^-10
        # relative); over a random-sign K-term sum the error relative
        # to the largest output stays near that step, so 4 * 2^-10
        # passes TF32 and still fails a wrong kernel.
        self.tolerance = {"int8": 1e-9, "tf32": 4 * 2.0 ** -10,
                          "bf16": 2.0 ** -16}[dtype]

    def setup(self) -> None:
        self._reject_dp()
        import jax.numpy as jnp

        from gpuaudiobench_jax.ops.speedoflight import (
            matmul_bf16,
            matmul_int8,
            matmul_tf32,
        )

        d = self.cfg.sol_matmul_dim
        a = generate_random_audio(d * d, self.cfg.seed).reshape(d, d)
        b = generate_random_audio(d * d, self.cfg.seed + 1).reshape(d, d)
        if self.dtype == "bf16":
            # Inputs live as bf16 on host AND device: casting inside the
            # timed body costs two extra full passes over the operands.
            # Golden sees the same rounded values the tensor cores do.
            a = np.asarray(jnp.asarray(a, jnp.bfloat16))
            b = np.asarray(jnp.asarray(b, jnp.bfloat16))
            self._fn = matmul_bf16
        elif self.dtype == "int8":
            # Full-range int8 operands (the pre-cast discipline of the
            # bf16 case: quantization happens at setup, never in the
            # timed body).
            a = np.clip(np.round(a * 127.0), -127, 127).astype(np.int8)
            b = np.clip(np.round(b * 127.0), -127, 127).astype(np.int8)
            self._fn = matmul_int8
        else:
            self._fn = matmul_tf32
        self.host_a, self.host_b = a, b
        self._ra = dev.to_device(a)
        self._rb = dev.to_device(b)
        if self.dtype == "tf32":
            # f32 BLAS golden: TF32's operand rounding dwarfs its error.
            self.golden = (
                a.astype(np.float32) @ b.astype(np.float32)
            ).astype(np.float32)
        else:
            # float64 BLAS golden. int8: every product and partial sum
            # is an integer below 2^53 (|sum| <= d * 127^2 < 2^31), so
            # f64 holds it exactly -- an int64 matmul has no BLAS path
            # and takes minutes at d = 4096. bf16: the products are
            # exact, and the f64 sum has no error of its own to mix
            # into the device's.
            self.golden = a.astype(np.float64) @ b.astype(np.float64)
        self.track_alloc("matmulA", a.nbytes)
        self.track_alloc("matmulB", b.nbytes)
        self.track_alloc("matmulOut", d * d * 4)
        self.iterate()

    def iterate(self) -> None:
        a = dev.to_device(self.host_a)
        b = dev.to_device(self.host_b)
        self.host_output = dev.from_device(self._fn(a, b))

    def device_iterate(self) -> None:
        dev.block(self._fn(self._ra, self._rb))

    def stream_body(self):
        from gpuaudiobench_jax.harness.streaming import barrier_chain

        return barrier_chain(self._fn, self._ra, self._rb)

    def validate(self) -> ValidationData:
        # Entries are sums of d O(1) terms, so |golden| spans orders of
        # magnitude. TF32's operand rounding and bf16's f32
        # accumulation are absolute errors at the output's scale, so
        # their checks are relative to the largest output; int8 is
        # exact (relative, with a zero-crossing floor).
        peak = float(np.abs(self.golden).max() or 1.0)
        floor = self.tolerance * peak if self.dtype == "int8" else peak
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def total_elements(self) -> int:
        return self.cfg.sol_matmul_dim ** 2

    _IN_BYTES = {"bf16": 2, "int8": 1, "tf32": 4}

    def bytes_processed(self) -> int:
        d = self.cfg.sol_matmul_dim
        return 2 * d * d * self._IN_BYTES[self.dtype] + d * d * 4

    def cost_model(self):
        d = self.cfg.sol_matmul_dim
        return {
            "flops": 2 * d**3,
            "hbm_bytes": self.bytes_processed(),
            "unit": self.dtype,
            "note": f"{d}^3 {self.dtype} matmul",
        }

    def metadata(self) -> Dict[str, Any]:
        return {"matmulDim": self.cfg.sol_matmul_dim, "dtype": self.dtype}
