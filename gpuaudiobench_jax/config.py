"""Global benchmark configuration.

Mirrors the reference's cross-benchmark globals (cuda/globals.cu:4-9:
FS=48000, NTRACKS=128, BUFSIZE=512, NRUNS=100) plus the Metal harness's
extended flags (metal-swift/.../main.swift:48-163: --benchmarkFilter,
--verification, --dawsim*, warmup) as one immutable dataclass threaded
through the harness instead of mutable globals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    # Core parameters (cuda/globals.cu defaults).
    fs: int = 48000
    buffer_size: int = 512
    n_tracks: int = 128
    n_runs: int = 100
    warmup: int = 3  # cuda/main.cu:130 hardcodes 3 warmup iterations

    # Output control.
    # Quiet mode: suppress progress chatter, keep results (the WebGPU
    # UI's quiet toggle, webgpu/js/core/GPUABenchmark.js:91-97).
    quiet: bool = False
    output_file: str = ""  # CSV path ("" = no CSV), cuda/globals.cu:8
    json_output: bool = False  # cuda/globals.cu:9
    latencies_file: str = ""  # raw latency dump; default /tmp/<name>_latencies.txt
    write_latencies: bool = True

    # Validation (Metal --verification none|spot|full,
    # metal-swift/.../GPUABenchmark.swift:527-568).
    verification: str = "full"
    spot_sample_limit: int = 1024

    # DAW-load simulation (metal-swift/.../BenchmarkUtilities.swift:140-178).
    dawsim: bool = False
    dawsim_mode: str = "spin"  # "spin" | "sleep"
    dawsim_jitter_us: float = 0.0

    # Profiler trace (Metal --capture -> MTLCaptureManager analog:
    # jax.profiler trace directory).
    capture: bool = False
    capture_dir: str = "/tmp/audiobench_trace"

    # Benchmark-specific knobs.
    ir_length: Optional[int] = None  # Conv1D default 1024, Conv1D_accel 512
    conv_edge_mode: str = "clamp"  # "clamp" (Metal/accel) | "bleed" (CUDA quirk)
    # PartConv FDL form: "shift" (textbook move-every-slot; DEFAULT) |
    # "ring" (one-slot write + contiguous doubled-H window; no FDL
    # rewrite, but an unfused window copy in chained streams) |
    # "nupols" (two-level Gardner non-uniform partitioning: K*B-sized
    # tail partitions fired once per K blocks with the MAC spread
    # across the window -- ~K-fold cut of the tail's per-block
    # device-memory traffic, the production long-IR scheme).
    partconv_form: str = "shift"
    # nupols tail partition size, in blocks (K): tail partitions are
    # K*B taps, head is exactly K B-sized partitions (the causality
    # bound, ops/partconv.py module docstring).
    partconv_tail_chunk: int = 8
    # IR-spectra storage dtype: "f32" | "f16". f16 halves the H read;
    # its error is held to the 1e-3 peak-relative contract
    # (models/partconv.py). Compute stays f32 either way.
    partconv_h_dtype: str = "f32"
    # NeuralAmp (streaming TCN inference, the matrix-unit workload):
    # channel width, dilated-layer count (receptive field
    # (K-1)(2^L-1)+1 = 2047 samples ~ 43 ms at 48 kHz with the
    # defaults), and GEMM dtype. "f32" contracts at
    # ops/neuralamp.py F32_GEMM_PRECISION and is validated to 1e-4
    # rel-to-peak; "bf16" is the tensor-core inference mode with its
    # own documented 2e-2 contract (models/neuralamp.py).
    neuralamp_channels: int = 128
    neuralamp_layers: int = 10
    neuralamp_dtype: str = "f32"
    # DAWSessionMix: per-track EQ-cascade depth (models/session.py);
    # the reverb IR length rides the shared --irLength knob.
    session_eq_stages: int = 4
    # IIRFilter recurrence form: "scan" (the per-sample sequential
    # recurrence, the reference's semantics and the DEFAULT) |
    # "blockstate" (linear-recurrence block advance: m samples per
    # step via precomputed Toeplitz taps, chain length S/m --
    # ops/iir.py blockstate_tables). Same filter; A/B in
    # iir_block_m = 0 means auto (16), always clamped to the largest
    # divisor of buffer_size (ops/iir.py blockstate_effective_m).
    iir_form: str = "scan"
    iir_block_m: int = 0
    seed: int = 42
    # datacopy* base pool (CUDA default 10 MiB; the poster also measured
    # 100 MiB and 1 GiB variants, BASELINE.md tab5/tab8).
    transfer_mib: int = 10
    # RndMemRead pool (bench_rndmem.cuh: 512 MiB, loop wrap 1000-48000).
    rndmem_pool_mb: int = 512
    rndmem_min_loop: int = 1000
    rndmem_max_loop: int = 48000
    # DWG delay-line length distribution (CUDA bench_dwg.cuh defaults
    # 100-2000; Metal uses 64-1024 -- reachable via these flags,
    # SURVEY.md divergence note).
    dwg_min_length: int = 100
    dwg_max_length: int = 2000
    # ModalFilterBank: None = min(1024*nTracks, 1M) (ModalFilterBankBenchmark.swift:20).
    modal_num_modes: Optional[int] = None
    # Streaming-only: renormalize each mode's phasor magnitude to its
    # initial value every block (~5 ops/mode vs the rotation's ~3000 --
    # <0.2% cost). The reference never renormalizes (bench_modal.cu),
    # so the default keeps its slow exponential amplitude drift from
    # f32 rounding. Off for benchmark parity; on for indefinite
    # production synthesis.
    modal_renorm: bool = False
    # FDTD3D: give each track its own receiver cell (WebGPU parity,
    # webgpu/js/benchmarks/FDTD3DBenchmark.js:57-67); default is the
    # CUDA/Metal single broadcast receiver.
    fdtd_per_track_receivers: bool = False
    # FDTD3D room size in cells per axis (grid = room + 2 ghost cells).
    # 50 = the CUDA/Metal reference (bench_fdtd3d.cuh:12-38); the
    # WebGPU build exposes 10-100 (ParameterBuilder.js fdtdParams).
    # Source/receiver scale with the room at the reference's fractions
    # (ops/fdtd3d.py source_pos/receiver_pos: exact reference cells at
    # room 50).
    fdtd_room: int = 50

    # Separate device-only timing pass (the cudaEvent / gpuStartTime analog:
    # times the jitted computation on device-resident buffers, excluding
    # host<->HBM transfers).
    device_timing: bool = True

    # Multi-device: shard the track axis over this many devices (1 = one device).
    data_parallel: int = 1

    # Multi-chip mesh for MultiChipSuite/LinkBandwidth: "dp,tp,sp"
    # (product must not exceed available devices; "1,1,1" runs the
    # degenerate single-device program).
    mesh: str = "1,1,1"

    # CSV schema: "cuda" (globals.cu:69-122, the parity default) or
    # "metal" (main.swift:256: benchmark,median_ms,p95_ms,p99_ms,max_ms,
    # mean_ms,stddev_ms,count).
    csv_schema: str = "cuda"

    # speedoflight microbenchmarks (SOL_*): what the card reaches,
    # reported beside its published peaks. Sizes chosen so compute
    # (FMA/matmul) or device-memory traffic (stream) dominates by >30x.
    sol_fma_k: int = 512  # FMA passes per element (intensity k/4 FLOP/B)
    sol_fma_mib: int = 8  # FMA working-set MiB
    # stream array MiB: each of input and output exceeds the 50 MB L2.
    sol_stream_mib: int = 256
    sol_matmul_dim: int = 4096  # square matmul dimension

    # Saturated/streaming pass: run this many blocks per executable
    # (lax.scan, state carried) and report marginal ms/block +
    # blocks/sec next to the round-trip stats. 0/1 = off.
    # 21 reps so the saturated tier gets the reference's percentile
    # discipline (globals.cu:101-122) with p95 actually distinct from
    # the max (truncated-index formula: int(21*0.95)=19 < 20; at
    # n=20 both p95 and p99 collapse to the max). p99 still equals the
    # max below n=100 -- exactly as it does in the reference's own
    # default nRuns=100 round-trip stats (int(100*0.99)=99 = last).
    pipeline_depth: int = 0
    saturated_reps: int = 21
    # Saturated marginal tier: also time a second, shorter chain
    # (depth//4) interleaved with the full-depth one and publish the
    # depth-differenced marginal ms/block -- the chip's per-block cost
    # with the rig's fixed sync floor cancelled (streaming.
    # measure_saturated_marginal; VERDICT r4 weak #1). blocks_per_sec
    # derives from the marginal when this is on. Costs one extra
    # compile + ~25% extra saturated wall; --noSaturatedMarginal
    # restores the single-chain amortized-only pass.
    saturated_marginal: bool = True
    # Overlapped-infeed pass (--overlapDepth): double-buffer host->HBM
    # uploads against device compute over this many blocks and report
    # serial vs overlapped steady-state ms/block (harness/overlap.py;
    # SURVEY §2.4's PP-axis "double-buffered infeed"). 0/1 = off.
    overlap_depth: int = 0
    overlap_reps: int = 5

    def deadline_ms(self) -> float:
        """Real-time deadline: 1000*BUFSIZE/FS ms (cuda/globals.cu:55,89)."""
        return 1000.0 * self.buffer_size / self.fs

    def replace(self, **kw) -> "BenchConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.buffer_size <= 0 or self.n_tracks <= 0:
            raise ValueError("buffer_size and n_tracks must be positive")
        if self.fs <= 0:
            raise ValueError("fs must be positive")
        if self.n_runs <= 0:
            raise ValueError("n_runs must be positive")
        if self.verification not in ("none", "spot", "full"):
            raise ValueError(f"invalid verification mode: {self.verification}")
        if self.dawsim_mode not in ("spin", "sleep"):
            raise ValueError(f"invalid dawsim mode: {self.dawsim_mode}")
        if self.conv_edge_mode not in ("clamp", "bleed"):
            raise ValueError(f"invalid conv edge mode: {self.conv_edge_mode}")
        if not 8 <= self.fdtd_room <= 128:
            raise ValueError(
                f"fdtd_room must be in [8, 128], got {self.fdtd_room}")
        if not 2 <= self.partconv_tail_chunk <= 64:
            raise ValueError(
                "partconv_tail_chunk must be in [2, 64], got "
                f"{self.partconv_tail_chunk}")
        if self.partconv_form not in ("ring", "shift", "nupols"):
            raise ValueError(
                f"invalid partconv form: {self.partconv_form}")
        if self.partconv_h_dtype not in ("f32", "f16"):
            raise ValueError(
                f"invalid partconv H dtype: {self.partconv_h_dtype}")
        if self.iir_form not in ("scan", "blockstate"):
            raise ValueError(f"invalid iir form: {self.iir_form}")
        if self.iir_block_m != 0 and not 2 <= self.iir_block_m <= 128:
            raise ValueError(
                f"iir_block_m ({self.iir_block_m}) must be 0 (auto) "
                "or in [2, 128]")
        if self.iir_form == "blockstate":
            # Both blockstate forms advance m >= 2 samples per step, so
            # the buffer needs a divisor in [2, cap] (a prime buffer
            # size has none; fail here, not at trace time).
            cap = min(self.iir_block_m or 128, self.buffer_size)
            if not any(self.buffer_size % m == 0
                       for m in range(2, cap + 1)):
                raise ValueError(
                    f"blockstate needs a buffer_size divisor in "
                    f"[2, {cap}]; {self.buffer_size} has none -- "
                    "use iir_form scan")
        if not 1 <= self.session_eq_stages <= 16:
            # Staggered cutoffs 0.25 - 0.0125*k stay positive through
            # 16 stages (models/session.py).
            raise ValueError(
                f"session_eq_stages ({self.session_eq_stages}) must be "
                "in [1, 16]")
        if self.neuralamp_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"invalid NeuralAmp dtype: {self.neuralamp_dtype}")
        if not 1 <= self.neuralamp_channels <= 512:
            raise ValueError(
                f"neuralamp_channels ({self.neuralamp_channels}) must be "
                "in [1, 512]")
        if not 1 <= self.neuralamp_layers <= 12:
            # Carried-tail memory doubles per layer ((K-1)*2^l samples
            # per track per layer); 12 layers = 16 s receptive field.
            raise ValueError(
                f"neuralamp_layers ({self.neuralamp_layers}) must be "
                "in [1, 12]")
        if self.csv_schema not in ("cuda", "metal"):
            raise ValueError(f"invalid csv schema: {self.csv_schema}")
        if self.dwg_min_length < 4:
            raise ValueError("dwg_min_length must be >= 4")
        if self.dwg_max_length < self.dwg_min_length:
            raise ValueError(
                f"dwg_max_length ({self.dwg_max_length}) must be >= "
                f"dwg_min_length ({self.dwg_min_length})"
            )


def matches_filter(name: str, patterns: Sequence[str]) -> bool:
    """Metal-style benchmark filter matching (main.swift:213-250),
    three tiers per pattern token, any hit selects the benchmark:

      1. ``/regex/`` -- case-insensitive regex, slash-delimited
         (main.swift:224-233); an invalid regex is reported and
         ignored, as the reference does (it prints and skips).
      2. exact -- case-insensitive whole-name equality
         (caseInsensitiveCompare, main.swift:234). In the reference
         this tier is subsumed by the substring tier (equality implies
         containment), so it needs no separate branch here; ``=token``
         below is what makes exactness observable.
      3. substring -- case-insensitive containment (main.swift:236).

    ``=token`` restricts a token to the exact tier only (an extension:
    without it "gain" cannot select gain without also selecting
    GainStats).
    """
    import re

    if not patterns:
        return True
    for pat in patterns:
        if len(pat) > 2 and pat.startswith("/") and pat.endswith("/"):
            try:
                if re.search(pat[1:-1], name, flags=re.IGNORECASE):
                    return True
            except re.error as e:
                print(f"Invalid regex pattern: {pat} -> {e}")
        elif pat.startswith("=") and len(pat) > 1:
            if pat[1:].lower() == name.lower():
                return True
        elif pat.lower() in name.lower():
            return True
    return False
