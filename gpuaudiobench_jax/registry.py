"""Benchmark registry: the 17 reference names -> factories
(cuda/main.cu:82-103 getBenchmarkRegistry; registration order preserved).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import Benchmark


def _factories() -> Dict[str, Callable[[BenchConfig], Benchmark]]:
    # Imports deferred so host-only tooling (stats, CSV) never imports jax.
    from gpuaudiobench_jax.models.biquad_chain import BiquadChainBenchmark
    from gpuaudiobench_jax.models.conv1d import Conv1DBenchmark
    from gpuaudiobench_jax.models.conv1d_accel import Conv1DAccelBenchmark
    from gpuaudiobench_jax.models.datatransfer import DataTransferBenchmark
    from gpuaudiobench_jax.models.dwg import DWGBenchmark
    from gpuaudiobench_jax.models.fdtd3d import FDTD3DBenchmark
    from gpuaudiobench_jax.models.fft import FFTBenchmark
    from gpuaudiobench_jax.models.gain import GainBenchmark
    from gpuaudiobench_jax.models.gainstats import GainStatsBenchmark
    from gpuaudiobench_jax.models.iir import IIRBenchmark
    from gpuaudiobench_jax.models.modal import ModalFilterBankBenchmark
    from gpuaudiobench_jax.models.multichip_bench import (
        LinkBandwidthBenchmark,
        MultiChipSuiteBenchmark,
    )
    from gpuaudiobench_jax.models.neuralamp import NeuralAmpBenchmark
    from gpuaudiobench_jax.models.noop import NoOpBenchmark
    from gpuaudiobench_jax.models.partconv import PartConvBenchmark
    from gpuaudiobench_jax.models.rndmem import RndMemBenchmark
    from gpuaudiobench_jax.models.session import DAWSessionMixBenchmark
    from gpuaudiobench_jax.models.speedoflight import (
        SolFmaBenchmark,
        SolHbmStreamBenchmark,
        SolMmaBenchmark,
    )

    return {
        "NoOp": NoOpBenchmark,
        "gain": GainBenchmark,
        "GainStats": GainStatsBenchmark,
        "datacopy0199": lambda cfg: DataTransferBenchmark(cfg, "datacopy0199"),
        "datacopy2080": lambda cfg: DataTransferBenchmark(cfg, "datacopy2080"),
        "datacopy5050": lambda cfg: DataTransferBenchmark(cfg, "datacopy5050"),
        "datacopy8020": lambda cfg: DataTransferBenchmark(cfg, "datacopy8020"),
        "datacopy9901": lambda cfg: DataTransferBenchmark(cfg, "datacopy9901"),
        "FFT1D": FFTBenchmark,
        "IIRFilter": IIRBenchmark,
        "Conv1D": Conv1DBenchmark,
        "Conv1D_accel": Conv1DAccelBenchmark,
        "ModalFilterBank": ModalFilterBankBenchmark,
        "DWG1DNaive": lambda cfg: DWGBenchmark(cfg, accelerated=False),
        "DWG1DAccel": lambda cfg: DWGBenchmark(cfg, accelerated=True),
        "FDTD3D": FDTD3DBenchmark,
        "RndMemRead": RndMemBenchmark,
        # Extensions beyond the reference's registered set.
        "BiquadChain": BiquadChainBenchmark,
        "PartConv": PartConvBenchmark,
        "NeuralAmp": NeuralAmpBenchmark,
        "NeuralAmpLSTM": lambda cfg: NeuralAmpBenchmark(cfg, "lstm"),
        "DAWSessionMix": DAWSessionMixBenchmark,
        "MultiChipSuite": MultiChipSuiteBenchmark,
        "LinkBandwidth": LinkBandwidthBenchmark,
        # speedoflight: what the card reaches, beside its peaks.
        "SOL_FMA_f32": SolFmaBenchmark,
        "SOL_HBM": SolHbmStreamBenchmark,
        "SOL_MMA_bf16": lambda cfg: SolMmaBenchmark(cfg, "bf16"),
        "SOL_MMA_tf32": lambda cfg: SolMmaBenchmark(cfg, "tf32"),
        "SOL_MMA_int8": lambda cfg: SolMmaBenchmark(cfg, "int8"),
    }


# Registry order from cuda/main.cu:84-100.
BENCHMARK_NAMES: List[str] = [
    "NoOp",
    "gain",
    "GainStats",
    "datacopy0199",
    "datacopy2080",
    "datacopy5050",
    "datacopy8020",
    "datacopy9901",
    "FFT1D",
    "IIRFilter",
    "Conv1D",
    "Conv1D_accel",
    "ModalFilterBank",
    "DWG1DNaive",
    "DWG1DAccel",
    "FDTD3D",
    "RndMemRead",
]

# Extensions: workloads present in the reference tree but unregistered
# there (kernels_extra.metal), registered here for completeness.
EXTENSION_NAMES: List[str] = ["BiquadChain", "PartConv", "NeuralAmp",
                              "NeuralAmpLSTM", "DAWSessionMix",
                              "MultiChipSuite", "LinkBandwidth",
                              "SOL_FMA_f32", "SOL_HBM", "SOL_MMA_bf16",
                              "SOL_MMA_tf32", "SOL_MMA_int8"]

# Suite categories (the WebGPU UI's five groups, webgpu/js/app.js:46-79).
CATEGORIES = {
    "transfer": ["datacopy0199", "datacopy2080", "datacopy5050",
                 "datacopy8020", "datacopy9901"],
    "basic": ["NoOp", "gain", "GainStats"],
    "dsp": ["IIRFilter", "Conv1D", "Conv1D_accel", "ModalFilterBank",
            "FFT1D", "BiquadChain", "PartConv"],
    "physical": ["DWG1DNaive", "DWG1DAccel", "FDTD3D"],
    "memory": ["RndMemRead"],
    # Extension: neural audio inference (the matrix-unit workload class).
    "neural": ["NeuralAmp", "NeuralAmpLSTM"],
    # Extension: the composite production workload (EQ cascades ->
    # reverb send bus -> stereo mixdown in one jitted block).
    "session": ["DAWSessionMix"],
    # Extension: the multi-device layer as runnable workloads.
    "multichip": ["MultiChipSuite", "LinkBandwidth"],
    # Extension: what the card reaches, beside its published peaks.
    "speedoflight": ["SOL_FMA_f32", "SOL_HBM", "SOL_MMA_bf16",
                     "SOL_MMA_tf32", "SOL_MMA_int8"],
}

BENCHMARK_DESCRIPTIONS = {
    "NoOp": "No-operation baseline (dispatch overhead)",
    "gain": "Simple gain/volume control",
    "GainStats": "Gain with statistical analysis",
    "datacopy0199": "1% input, 99% output transfer",
    "datacopy2080": "20% input, 80% output transfer",
    "datacopy5050": "50% input, 50% output transfer",
    "datacopy8020": "80% input, 20% output transfer",
    "datacopy9901": "99% input, 1% output transfer",
    "FFT1D": "1D Fast Fourier Transform",
    "IIRFilter": "Infinite Impulse Response filter",
    "Conv1D": "1D convolution",
    "Conv1D_accel": "Accelerated 1D convolution",
    "ModalFilterBank": "Modal synthesis filter bank",
    "DWG1DNaive": "1D Digital Waveguide (naive)",
    "DWG1DAccel": "1D Digital Waveguide (accelerated)",
    "FDTD3D": "3D Finite Difference Time Domain",
    "RndMemRead": "Random memory access pattern",
    "BiquadChain": "Serial 10-stage biquad cascade (extension)",
    "PartConv": "Partitioned streaming convolution reverb (extension)",
    "NeuralAmp": "Streaming neural amp-model (TCN) inference on the "
                 "tensor cores (extension)",
    "NeuralAmpLSTM": "Streaming LSTM amp-model inference (per-sample "
                     "recurrence; extension)",
    "DAWSessionMix": "Full mixing-session graph: per-track EQ cascade -> "
                     "reverb send bus -> stereo mixdown (extension)",
    "MultiChipSuite": "Sharded dp/tp/sp/pp pipeline over --mesh (extension)",
    "LinkBandwidth": "Interconnect ring ppermute + psum (extension)",
    "SOL_FMA_f32": "Speed-of-light: f32 FMA chain on the CUDA cores",
    "SOL_HBM": "Speed-of-light: device-memory stream (read + write)",
    "SOL_MMA_bf16": "Speed-of-light: bf16 tensor-core matmul",
    "SOL_MMA_tf32": "Speed-of-light: TF32 tensor-core matmul (f32 operands)",
    "SOL_MMA_int8": "Speed-of-light: s8xs8->s32 tensor-core matmul",
}


def create_benchmark(name: str, cfg: BenchConfig) -> Benchmark:
    factories = _factories()
    if name not in factories:
        raise KeyError(f"Unknown benchmark: {name}")
    return factories[name](cfg)


def list_benchmarks() -> List[str]:
    return list(BENCHMARK_NAMES) + list(EXTENSION_NAMES)
