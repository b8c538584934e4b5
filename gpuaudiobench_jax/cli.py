"""Command-line interface.

Reproduces the CUDA CLI surface (cuda/main.cu:177-304: --help --list
--benchmark --fs --bufferSize --nTracks --nRuns --outputfile --json,
default benchmark RndMemRead) plus the Metal extensions
(metal-swift/.../main.swift:48-163: --benchmarkFilter with substring or
/regex/ patterns and multi-benchmark runs, --verification
none|spot|full, --dawsim, --dawsim-mode spin|sleep, --dawsim-jitter-us,
--warmup, --capture) and this build's additions (--irLength,
--convEdgeMode, --poolMiB, --seed, --no-device-timing).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from gpuaudiobench_jax.config import BenchConfig, matches_filter
from gpuaudiobench_jax.registry import (
    BENCHMARK_DESCRIPTIONS,
    BENCHMARK_NAMES,
    EXTENSION_NAMES,
    create_benchmark,
    list_benchmarks,
)

DEFAULT_BENCHMARK = "RndMemRead"  # cuda/main.cu:239


def print_help() -> None:
    print("Audio Benchmark Suite")
    print("=====================")
    print("Real-time accelerator audio processing benchmarks\n")
    print("Usage: gpubench [options]\n")
    print("Options:")
    print("  --help                   Print this help message")
    print("  --list                   List all available benchmarks")
    print("  --benchmark [name]       Run specific benchmark (see list below)")
    print("  --benchmarkFilter [pat]  Run all benchmarks matching substring or /regex/")
    print("                           (repeatable / comma separated)")
    print("  --category [name]        Run a suite category: transfer | basic | dsp")
    print("                           | physical | memory | neural | multichip")
    print("                           | speedoflight")
    print("  --fs [rate]              Set sampling rate (default: 48000)")
    print("  --bufferSize [size]      Set buffer size (default: 512)")
    print("  --nTracks [count]        Set number of tracks (default: 128)")
    print("  --nRuns [count]          Set number of iterations (default: 100)")
    print("  --warmup [count]         Set warmup iterations (default: 3)")
    print("  --outputfile [file]      Save results to CSV file")
    print("  --json                   Output results in JSON format")
    print("  --verification [mode]    none | spot | full (default: full)")
    print("  --dawsim                 Pace iterations at the audio buffer rate")
    print("  --dawsim-mode [mode]     spin | sleep (default: spin)")
    print("  --dawsim-jitter-us [us]  Schedule jitter in microseconds")
    print("  --capture                Write a jax profiler trace")
    print("  --irLength [n]           Conv1D/Conv1D_accel IR length")
    print("  --convEdgeMode [m]       clamp | bleed (Conv1D edge handling)")
    print("  --partconvForm [f]       shift | ring | nupols (PartConv "
          "FDL form; default shift)")
    print("  --partconvTailChunk [k]  nupols tail partition size in "
          "blocks (default 8)")
    print("  --partconvHDtype [d]     f32 | f16 (PartConv IR-spectra storage)")
    print("  --neuralampChannels [n]  NeuralAmp TCN channel count (default: 128)")
    print("  --neuralampLayers [n]    NeuralAmp dilated-layer count (default: 10)")
    print("  --neuralampDtype [d]     f32 | bf16 | int8 (NeuralAmp GEMM dtype; int8 TCN-only)")
    print("  --sessionEqStages [k]    DAWSessionMix per-track EQ cascade "
          "depth (default: 4)")
    print("  --iirForm [f]            scan | blockstate (IIRFilter "
          "recurrence form; default scan)")
    print("  --iirBlockM [m]          blockstate samples per step "
          "(default 0 = auto: 16, clamped to a bufferSize divisor)")
    print("  --poolMiB [n]            RndMemRead pool size (default: 512)")
    print("  --transferMiB [n]        datacopy* pool size (default: 10)")
    print("  --dataParallel [n]       Shard tracks over n devices (default: 1)")
    print("  --fdtdPerTrackReceivers  FDTD3D: one receiver cell per track")
    print("                           (WebGPU parity; default: broadcast)")
    print("  --fdtdRoom [n]           FDTD3D room cells per axis "
          "(default 50; grid = n+2)")
    print("  --dwgMinLen/--dwgMaxLen [n]  DWG delay-line length range")
    print("                           (CUDA default 100-2000; Metal used 64-1024)")
    print("  --modalModes [n]         ModalFilterBank mode count")
    print("                           (default: min(1024*nTracks, 1M))")
    print("  --modalRenorm            Streaming: renormalize phasor magnitudes")
    print("                           every block (off = reference parity)")
    print("  --pipelineDepth [n]      Also measure saturated throughput:")
    print("                           n blocks per executable, state carried")
    print("  --saturatedReps [n]      Saturated-tier repetitions (default: 21;")
    print("                           use >=101 for a true p99)")
    print("  --noSaturatedMarginal    Skip the marginal saturated tier (the")
    print("                           depth-differenced per-block cost that")
    print("                           cancels the rig's sync floor; on by")
    print("                           default when --pipelineDepth >= 4)")
    print("  --overlapDepth [n]       Also measure overlapped infeed: upload")
    print("                           block k+1 while block k computes, vs")
    print("                           the serial twin (n blocks per rep)")
    print("  --overlapReps [n]        Overlap-tier repetitions (default: 5)")
    print("  --captureDir [dir]       Profiler trace directory for --capture")
    print("  --csvSchema [s]          cuda (default) | metal CSV column set")
    print("  --mesh [dp,tp,sp]        Device mesh for MultiChipSuite /")
    print("                           LinkBandwidth (default: 1,1,1)")
    print("  --solMatmulDim [n]       SOL_MMA_* matmul dimension (default: 4096)")
    print("  --solStreamMiB [n]       SOL_HBM stream size (default: 256)")
    print("  --solFmaK [n]            SOL_FMA_f32 FMA passes (default: 512)")
    print("  --solFmaMiB [n]          SOL_FMA_f32 working set (default: 8)")
    print("  --seed [n]               Test-data seed (default: 42)")
    print("  --no-device-timing       Skip the device-only timing pass")
    print("  --quiet                  Suppress progress output (results only)")
    print()
    print("The persistent XLA compile cache is $JAX_COMPILATION_CACHE_DIR,")
    print("or .jax_cache at the root of the checkout when that is unset.")
    print()
    print("Available Benchmarks:")
    print("=====================")
    for name in list_benchmarks():
        print(f"  {name:<16} - {BENCHMARK_DESCRIPTIONS[name]}")
    print()
    print("Examples:")
    print("  gpubench --benchmark gain")
    print("  gpubench --benchmark IIRFilter --bufferSize 1024 --nTracks 128")
    print("  gpubench --benchmarkFilter /conv/ --json")


def print_list() -> None:
    print("Available benchmarks:")
    for name in list_benchmarks():
        print(name)


def parse_args(argv: List[str]):
    """Returns (cfg, benchmark_names, error_message)."""
    cfg = BenchConfig()
    benchmark: Optional[str] = None
    filters: List[str] = []
    categories: List[str] = []
    i = 0
    updates = {}

    def need_value(flag: str) -> Optional[str]:
        nonlocal i
        if i + 1 >= len(argv):
            return None
        i += 1
        return argv[i]

    value_flags = {
        "--benchmark": ("benchmark", str),
        "--fs": ("fs", int),
        "--bufferSize": ("buffer_size", int),
        "--nTracks": ("n_tracks", int),
        "--nRuns": ("n_runs", int),
        "--warmup": ("warmup", int),
        "--outputfile": ("output_file", str),
        "--verification": ("verification", str),
        "--dawsim-mode": ("dawsim_mode", str),
        "--dawsim-jitter-us": ("dawsim_jitter_us", float),
        "--irLength": ("ir_length", int),
        "--convEdgeMode": ("conv_edge_mode", str),
        "--partconvForm": ("partconv_form", str),
        "--partconvTailChunk": ("partconv_tail_chunk", int),
        "--partconvHDtype": ("partconv_h_dtype", str),
        "--neuralampChannels": ("neuralamp_channels", int),
        "--neuralampLayers": ("neuralamp_layers", int),
        "--neuralampDtype": ("neuralamp_dtype", str),
        "--sessionEqStages": ("session_eq_stages", int),
        "--iirForm": ("iir_form", str),
        "--iirBlockM": ("iir_block_m", int),
        "--poolMiB": ("rndmem_pool_mb", int),
        "--fdtdRoom": ("fdtd_room", int),
        "--transferMiB": ("transfer_mib", int),
        "--dataParallel": ("data_parallel", int),
        "--modalModes": ("modal_num_modes", int),
        "--dwgMinLen": ("dwg_min_length", int),
        "--dwgMaxLen": ("dwg_max_length", int),
        "--pipelineDepth": ("pipeline_depth", int),
        "--saturatedReps": ("saturated_reps", int),
        "--overlapDepth": ("overlap_depth", int),
        "--overlapReps": ("overlap_reps", int),
        "--captureDir": ("capture_dir", str),
        "--csvSchema": ("csv_schema", str),
        "--mesh": ("mesh", str),
        "--solFmaK": ("sol_fma_k", int),
        "--solFmaMiB": ("sol_fma_mib", int),
        "--solStreamMiB": ("sol_stream_mib", int),
        "--solMatmulDim": ("sol_matmul_dim", int),
        "--seed": ("seed", int),
        "--latenciesFile": ("latencies_file", str),
    }

    while i < len(argv):
        arg = argv[i]
        if arg == "--help":
            return None, ["--help"], None
        if arg == "--list":
            return None, ["--list"], None
        if arg == "--json":
            updates["json_output"] = True
        elif arg == "--quiet":
            updates["quiet"] = True
        elif arg == "--dawsim":
            updates["dawsim"] = True
        elif arg == "--capture":
            updates["capture"] = True
        elif arg == "--no-device-timing":
            updates["device_timing"] = False
        elif arg == "--noSaturatedMarginal":
            updates["saturated_marginal"] = False
        elif arg == "--fdtdPerTrackReceivers":
            updates["fdtd_per_track_receivers"] = True
        elif arg == "--modalRenorm":
            updates["modal_renorm"] = True
        elif arg == "--category":
            v = need_value(arg)
            if v is None:
                return None, [], f"Error: {arg} requires an argument"
            from gpuaudiobench_jax.registry import CATEGORIES

            if v not in CATEGORIES:
                return None, [], (
                    f"Error: unknown category '{v}' "
                    f"(choose from {', '.join(CATEGORIES)})"
                )
            categories.extend(CATEGORIES[v])
        elif arg == "--benchmarkFilter":
            v = need_value(arg)
            if v is None:
                return None, [], f"Error: {arg} requires an argument"
            filters.extend(p for p in v.split(",") if p)
        elif arg in value_flags:
            v = need_value(arg)
            if v is None:
                return None, [], f"Error: {arg} requires an argument"
            key, typ = value_flags[arg]
            try:
                val = typ(v)
            except ValueError:
                return None, [], f"Error: invalid value for {arg}: {v}"
            if key == "benchmark":
                benchmark = val
            else:
                updates[key] = val
        else:
            print(f"Warning: Unparsed argument: {arg}")
        i += 1

    cfg = cfg.replace(**updates)
    try:
        cfg.validate()
    except ValueError as e:
        return None, [], f"Error: {e}"

    if filters or categories:
        all_names = BENCHMARK_NAMES + EXTENSION_NAMES
        names = [n for n in all_names
                 if (filters and matches_filter(n, filters)) or n in categories]
        if benchmark and benchmark not in names:
            names.append(benchmark)
        if not names:
            return None, [], "Error: no benchmarks match the given filter"
    elif benchmark is not None:
        names = [benchmark]
    else:
        names = [DEFAULT_BENCHMARK]
    return cfg, names, None


def run(cfg: BenchConfig, names: List[str]) -> int:
    # Imported lazily: pulls in jax.
    from gpuaudiobench_jax.utils.device import enable_compilation_cache

    enable_compilation_cache()
    from gpuaudiobench_jax.harness.output import (
        print_results,
        write_csv_results,
        write_latencies_file,
    )
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.utils import device as dev

    print("Audio Benchmark")
    print(f"Found {len(__import__('jax').devices())} device(s): "
          f"{dev.default_device().device_kind} [{dev.platform()}]")

    exit_code = 0
    json_results = []
    for name in names:
        try:
            bench = create_benchmark(name, cfg)
        except KeyError:
            print(f"Error: Unknown benchmark '{name}'")
            print("Use --list to see available benchmarks.")
            return 1
        # One failing benchmark doesn't kill the suite (main.swift:261-341).
        try:
            if not cfg.quiet:
                print(f"Setting up {name} benchmark...")
            bench.setup()
            if not cfg.quiet:
                print(
                    f"Running {name} benchmark ({cfg.n_runs} iterations "
                    f"with {cfg.warmup} warmup)..."
                )
            result = run_benchmark(bench, cfg, verbose=not cfg.quiet)
            if result.validation is not None and not result.validation.passed:
                exit_code = 1
            if cfg.json_output:
                from gpuaudiobench_jax.harness.output import generate_json_results

                json_results.append(generate_json_results(result, cfg))
            else:
                print_results(result, cfg)
                if cfg.write_latencies:
                    write_latencies_file(result, cfg.latencies_file)
                if cfg.output_file:
                    write_csv_results(result, cfg, cfg.output_file)
            if result.deadline_miss_rate is not None and result.deadline_miss_rate > 0:
                print(
                    f"WARNING: {name} missed {result.deadline_miss_rate:.1f}% "
                    f"of buffer deadlines under DAW pacing"
                )
            bench.cleanup()
        except Exception as e:  # noqa: BLE001 - suite resilience
            print(f"Benchmark {name} failed: {e}")
            exit_code = 1

    if cfg.json_output:
        import json as _json

        payload = (
            _json.dumps(json_results[0], indent=2)
            if len(json_results) == 1
            else _json.dumps(json_results, indent=2)
        )
        if cfg.output_file:
            with open(cfg.output_file, "w") as f:
                f.write(payload)
            print(f"JSON results saved to: {cfg.output_file}")
        else:
            print(payload)
    print("Done")
    return exit_code


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, names, err = parse_args(argv)
    if err:
        print(err)
        return 1
    if names == ["--help"]:
        print_help()
        return 0
    if names == ["--list"]:
        print_list()
        return 0
    return run(cfg, names)


if __name__ == "__main__":
    sys.exit(main())
