"""CLI surface + output writer tests."""

import json

from gpuaudiobench_jax.cli import parse_args
from gpuaudiobench_jax.config import BenchConfig, matches_filter
from gpuaudiobench_jax.harness.base import BenchmarkResult
from gpuaudiobench_jax.harness.output import (
    CSV_HEADER,
    generate_json_results,
    write_csv_results,
)
from gpuaudiobench_jax.harness.statistics import calculate_statistics


def test_defaults():
    cfg, names, err = parse_args([])
    assert err is None
    assert names == ["RndMemRead"]  # cuda/main.cu:239 default
    assert cfg.fs == 48000
    assert cfg.buffer_size == 512
    assert cfg.n_tracks == 128
    assert cfg.n_runs == 100


def test_flag_parsing():
    cfg, names, err = parse_args(
        [
            "--benchmark", "gain", "--fs", "44100", "--bufferSize", "1024",
            "--nTracks", "256", "--nRuns", "50", "--json",
            "--outputfile", "/tmp/x.csv", "--verification", "spot",
            "--dawsim", "--dawsim-mode", "sleep", "--dawsim-jitter-us", "100",
            "--warmup", "5", "--irLength", "256",
        ]
    )
    assert err is None
    assert names == ["gain"]
    assert cfg.fs == 44100
    assert cfg.buffer_size == 1024
    assert cfg.n_tracks == 256
    assert cfg.n_runs == 50
    assert cfg.json_output
    assert cfg.output_file == "/tmp/x.csv"
    assert cfg.verification == "spot"
    assert cfg.dawsim and cfg.dawsim_mode == "sleep"
    assert cfg.dawsim_jitter_us == 100.0
    assert cfg.warmup == 5
    assert cfg.ir_length == 256


def test_missing_value_is_error():
    _, _, err = parse_args(["--benchmark"])
    assert err is not None


def test_invalid_mode_is_error():
    _, _, err = parse_args(["--verification", "bogus"])
    assert err is not None


def test_filter_matching():
    assert matches_filter("Conv1D_accel", ["conv"])
    assert matches_filter("Conv1D_accel", ["/conv1d_a.*/"])
    assert not matches_filter("gain", ["conv"])
    assert matches_filter("anything", [])


def test_filter_exact_tier():
    """Three-tier matching (main.swift:213-250): regex, exact
    (case-insensitive equality), substring; =token is exact-only."""
    assert matches_filter("gain", ["GAIN"])  # exact, case-insensitive
    assert matches_filter("GainStats", ["gain"])  # substring tier
    assert matches_filter("gain", ["=gain"])
    assert not matches_filter("GainStats", ["=gain"])  # exact-only
    assert not matches_filter("gain", ["=gai"])
    # Invalid regex is reported + skipped, not fatal (main.swift:229-231).
    assert not matches_filter("gain", ["/([/"])
    assert matches_filter("gain", ["/([/", "gain"])


def test_benchmark_filter_selects_multiple():
    _, names, err = parse_args(["--benchmarkFilter", "datacopy"])
    assert err is None
    assert len(names) == 5
    _, names, _ = parse_args(["--benchmarkFilter", "/^DWG/"])
    assert names == ["DWG1DNaive", "DWG1DAccel"]


def _result(latencies):
    r = BenchmarkResult(
        benchmark_name="gain",
        buffer_size=512,
        track_count=128,
        iterations=len(latencies),
        latencies=list(latencies),
    )
    r.statistics = calculate_statistics(r.latencies)
    return r


def test_csv_schema(tmp_path):
    cfg = BenchConfig()
    path = str(tmp_path / "out.csv")
    write_csv_results(_result([1.0, 2.0, 3.0]), cfg, path)
    write_csv_results(_result([4.0, 5.0, 6.0]), cfg, path)  # append, one header
    lines = open(path).read().strip().split("\n")
    from gpuaudiobench_jax.harness.output import CSV_CONTEXT_COLS

    assert lines[0] == CSV_HEADER + CSV_CONTEXT_COLS
    assert len(lines) == 3
    fields = lines[1].split(",")
    assert fields[0] == "gain"
    assert fields[1] == "48000"
    assert fields[12] in ("true", "false")


def test_csv_deadline_logic(tmp_path):
    cfg = BenchConfig()  # deadline = 10.667 ms
    path = str(tmp_path / "d.csv")
    write_csv_results(_result([1.0] * 100), cfg, path)
    write_csv_results(_result([100.0] * 100), cfg, path)
    lines = open(path).read().strip().split("\n")
    # meets_deadline is column 12; context columns follow it.
    assert lines[1].split(",")[12] == "true"
    assert lines[2].split(",")[12] == "false"


def test_json_schema():
    cfg = BenchConfig()
    out = generate_json_results(_result([1.0, 2.0, 3.0]), cfg)
    s = json.dumps(out)
    assert out["benchmark"] == "gain"
    assert out["configuration"]["bufferSize"] == 512
    assert "p99_ms" in out["statistics"]
    assert out["deadline"]["threshold_ms"] == cfg.deadline_ms()
    assert isinstance(json.loads(s), dict)


def test_category_selection():
    _, names, err = parse_args(["--category", "physical"])
    assert err is None
    assert names == ["DWG1DNaive", "DWG1DAccel", "FDTD3D"]
    _, names, _ = parse_args(["--category", "basic", "--category", "memory"])
    assert set(names) == {"NoOp", "gain", "GainStats", "RndMemRead"}
    _, _, err = parse_args(["--category", "bogus"])
    assert err is not None


def test_transfer_mib_flag():
    cfg, _, err = parse_args(["--transferMiB", "100"])
    assert err is None
    assert cfg.transfer_mib == 100


def test_data_parallel_flag():
    cfg, _, err = parse_args(["--dataParallel", "4"])
    assert err is None
    assert cfg.data_parallel == 4


def test_metal_csv_schema(small_cfg, tmp_path):
    """--csvSchema metal writes the Metal harness's column set
    (main.swift:256)."""
    from gpuaudiobench_jax.harness.output import write_csv_results
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = small_cfg.replace(csv_schema="metal")
    b = create_benchmark("gain", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    path = str(tmp_path / "metal.csv")
    write_csv_results(result, cfg, path)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == (
        "benchmark,median_ms,p95_ms,p99_ms,max_ms,mean_ms,stddev_ms,count"
    )
    row = lines[1].split(",")
    assert row[0] == "gain" and int(row[-1]) == cfg.n_runs


def test_csv_schema_flag_parses():
    from gpuaudiobench_jax.cli import parse_args

    cfg, names, err = parse_args(["--csvSchema", "metal"])
    assert err is None and cfg.csv_schema == "metal"
    _, _, err = parse_args(["--csvSchema", "bogus"])
    assert err and "csv schema" in err


def test_quiet_flag():
    cfg, names, err = parse_args(["--quiet", "--benchmark", "gain"])
    assert err is None and cfg.quiet is True
    cfg, _, _ = parse_args(["--benchmark", "gain"])
    assert cfg.quiet is False


def test_dwg_length_flags():
    cfg, _, err = parse_args(
        ["--benchmark", "DWG1DNaive", "--dwgMinLen", "64",
         "--dwgMaxLen", "1024"])
    assert err is None
    assert cfg.dwg_min_length == 64 and cfg.dwg_max_length == 1024


def test_dwg_length_range_validated():
    _, _, err = parse_args(
        ["--benchmark", "DWG1DNaive", "--dwgMinLen", "100",
         "--dwgMaxLen", "32"])
    assert err is not None and "dwg_max_length" in err
    _, _, err = parse_args(["--benchmark", "DWG1DNaive", "--dwgMinLen", "2"])
    assert err is not None and "dwg_min_length" in err
