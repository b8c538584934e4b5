"""datacopy*: host<->HBM transfer benchmarks at five input/output ratios
(cuda/bench_datatransfer.cu). Base pool = 10 MiB of floats
(bench_datatransfer.cuh:703: BASE_BUFFER_SIZE); per config the input is
ratio_in of the pool uploaded each iteration and the output is ratio_out
downloaded, with the device program copying the input portion and
synthesizing 0.5 + 0.5*sin(idx*0.001) beyond it (bench_datatransfer.cu:
15-25). The measured path is PJRT host->device / device->host DMA over
PCIe, the same path the reference measures (SURVEY.md s2.4).
"""

from __future__ import annotations

import numpy as np

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark
from gpuaudiobench_jax.harness.validation import ValidationData, compare_abs
from gpuaudiobench_jax.ops.elementwise import data_transfer_op
from gpuaudiobench_jax.utils import device as dev
from gpuaudiobench_jax.utils.data import generate_uniform01

BASE_BUFFER_SIZE = 10 * 1024 * 1024 // 4  # floats (CUDA default)

DATACOPY_CONFIGS = {
    "datacopy0199": (0.01, 0.99),
    "datacopy2080": (0.20, 0.80),
    "datacopy5050": (0.50, 0.50),
    "datacopy8020": (0.80, 0.20),
    "datacopy9901": (0.99, 0.01),
}


class DataTransferBenchmark(Benchmark):
    tolerance = 1e-5  # bench_datatransfer.cu:115

    def __init__(self, cfg: BenchConfig, name: str):
        super().__init__(cfg)
        self.name = name
        rin, rout = DATACOPY_CONFIGS[name]
        # --transferMiB scales the pool (poster tab5/tab8 used 100 MiB / 1 GiB)
        base = cfg.transfer_mib * 1024 * 1024 // 4
        self.input_size = int(base * rin)
        self.output_size = int(base * rout)
        self.host_input = None
        self.host_output = None
        self.golden = None
        self._resident_input = None

    def setup(self) -> None:
        # dp shards the flat transfer across devices (parallel host->HBM
        # DMA lanes); both portions must split evenly.
        self.setup_sharding(self.input_size, "input floats")
        if self.cfg.data_parallel > 1 and \
                self.output_size % self.cfg.data_parallel != 0:
            raise ValueError(
                f"output floats ({self.output_size}) must be divisible "
                f"by --dataParallel ({self.cfg.data_parallel})"
            )
        self.host_input = generate_uniform01(self.input_size, self.cfg.seed)
        self.track_alloc("inputBuffers", self.input_size * 4 * 2)
        self.track_alloc("outputBuffers", self.output_size * 4 * 2)
        # Pinned-host staging (the cudaMallocHost analog,
        # cuda/bench_utils.cu:101-155): where the runtime supports the
        # pinned_host memory kind, the host input lives in a
        # page-locked buffer allocated at setup and every iteration's
        # upload DMAs from it -- the reference's default H2D path. The
        # fallback is a pageable numpy source; metadata records which
        # path ran plus a measured A/B of the two (VERDICT r3 #3).
        self._pinned_input = None
        self._transfer_class = None
        if self.cfg.data_parallel <= 1:
            self._pinned_input = dev.stage_pinned(self.host_input)
        self._resident_input = self.put_sharded(self.host_input)
        idx = np.arange(self.output_size, dtype=np.float32)
        synth = (0.5 + 0.5 * np.sin(idx * np.float32(0.001))).astype(np.float32)
        n = min(self.input_size, self.output_size)
        golden = synth
        golden[:n] = self.host_input[:n]
        self.golden = golden
        self.iterate()

    def iterate(self) -> None:
        src = (self._pinned_input if self._pinned_input is not None
               else self.host_input)
        x = self.put_sharded(src)
        y = data_transfer_op(x, self.output_size)
        self.host_output = dev.from_device(y)

    def device_iterate(self) -> None:
        dev.block(data_transfer_op(self._resident_input, self.output_size))

    def overlap_body(self):
        """Overlapped-infeed hook: here the upload IS the workload, so
        this family is the purest serial-vs-pipelined A/B (VERDICT r3
        missing #2 / SURVEY §2.4 PP axis)."""
        out_size = self.output_size
        a = self.host_input
        blocks = [a, np.negative(a)]
        if self._pinned_input is not None:
            # True double-buffer: TWO pinned slots, like a pinned ring
            # buffer a DAW would cycle.
            pb = dev.stage_pinned(blocks[1])
            if pb is not None:
                blocks = [self._pinned_input, pb]
        return (lambda x, c: (data_transfer_op(x, out_size), c),
                blocks, ())

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )

    def cost_model(self):
        # The DEVICE program only reads the copied portion
        # (min(in, out) floats) and writes the output; the full input
        # upload is host-link traffic, not kernel HBM traffic --
        # counting it inflated datacopy9901's device-tier GB/s 18x
        # past the measured HBM peak (r3 review).
        copied = min(self.input_size, self.output_size)
        return {
            # sin synth runs only BEYOND the copied portion (zero when
            # out <= in: the synth branch is dead-code-eliminated).
            "flops": 2 * max(0, self.output_size - copied),
            "hbm_bytes": (copied + self.output_size) * 4,
            "unit": "fp32",
            "note": "measured path is host<->device, not device memory",
        }

    def bytes_processed(self) -> int:
        return (self.input_size + self.output_size) * 4

    def total_elements(self) -> int:
        return self.input_size + self.output_size

    def _transfer_class_ab(self, reps: int = 5) -> dict:
        """Measured pinned-vs-pageable staging A/B (the memory-class
        axis the reference's tab5 numbers were built to expose: every
        PC number there is a cudaMallocHost number). Pageable = numpy
        source (page-copy + DMA); pinned = page-locked source staged
        at setup (DMA only). D2H mirrors it: HBM -> pageable numpy vs
        device -> pinned host buffer. Only the support bits are recorded
        off the GPU (CPU timings would be meaningless)."""
        import time

        import jax

        info = {
            "pinned_supported": dev.pinned_host_sharding() is not None,
            "h2d_path_used": ("pinned" if self._pinned_input is not None
                              else "pageable"),
        }
        if dev.platform() != "gpu":
            return info

        def med(fn):
            vals = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                vals.append((time.perf_counter() - t0) * 1e3)
            return round(sorted(vals)[len(vals) // 2], 4)

        target = dev.default_device()
        hbm = dev.device_memory_sharding()
        info["ab_mib"] = round(self.input_size * 4 / 2**20, 3)
        info["h2d_pageable_ms"] = med(
            lambda: jax.device_put(self.host_input, target))
        # D2H must read a FRESH device buffer each rep: a jax.Array
        # caches its host copy after the first np.asarray, so reading
        # the resident input re-measures a cache hit (~0.01 ms), not a
        # transfer. The trivial on-device add allocates a new buffer
        # per rep (its cost is noise next to the transfer).
        info["d2h_pageable_ms"] = med(
            lambda: np.asarray(self._resident_input + 0.0))
        if info["pinned_supported"]:
            pinned_s = dev.pinned_host_sharding()
            if self._pinned_input is not None:
                info["h2d_pinned_ms"] = med(
                    lambda: jax.device_put(self._pinned_input, hbm))
            info["d2h_pinned_ms"] = med(
                lambda: jax.device_put(self._resident_input + 0.0,
                                       pinned_s))
        return info

    def metadata(self):
        if self._transfer_class is None:
            self._transfer_class = self._transfer_class_ab()
        return {
            "inputFloats": self.input_size,
            "outputFloats": self.output_size,
            "inputMiB": self.input_size * 4 / 2**20,
            "outputMiB": self.output_size * 4 / 2**20,
            "transferMemoryClass": self._transfer_class,
        }

