"""End-to-end CLI integration: the full process surface via subprocess
(hardware-free on the CPU backend)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "gpuaudiobench_jax.cli", *args],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO,
    )


def test_list_exits_zero():
    r = _run(["--list"])
    assert r.returncode == 0
    assert "RndMemRead" in r.stdout
    assert "BiquadChain" in r.stdout


def test_help_shows_flags():
    r = _run(["--help"])
    assert r.returncode == 0
    for flag in ("--benchmark", "--benchmarkFilter", "--verification",
                 "--dawsim", "--category"):
        assert flag in r.stdout


def test_unknown_benchmark_fails():
    r = _run(["--benchmark", "NoSuchBenchmark"])
    assert r.returncode == 1
    assert "Unknown benchmark" in r.stdout


def test_gain_json_end_to_end(tmp_path):
    out = tmp_path / "r.json"
    r = _run([
        "--benchmark", "gain", "--nRuns", "3", "--warmup", "1",
        "--bufferSize", "64", "--nTracks", "8", "--json",
        "--no-device-timing", "--outputfile", str(out),
    ])
    assert r.returncode == 0, r.stdout[-500:] + r.stderr[-500:]
    payload = json.loads(out.read_text())
    assert payload["benchmark"] == "gain"
    assert payload["validation"]["status"] == "SUCCESS"
    assert payload["deadline"]["threshold_ms"] == pytest.approx(64000 / 48000)
    assert len(payload["raw_latencies_ms"]) == 3


def test_csv_and_report_pipeline(tmp_path):
    csv = tmp_path / "r.csv"
    r = _run([
        "--benchmarkFilter", "gain,GainStats", "--nRuns", "3", "--warmup", "1",
        "--bufferSize", "64", "--nTracks", "8", "--no-device-timing",
        "--outputfile", str(csv),
    ])
    assert r.returncode == 0
    lines = csv.read_text().strip().split("\n")
    assert len(lines) == 3  # header + 2 benchmarks
    # analysis/compare.py consumes the CSV
    r2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "analysis", "compare.py"), str(csv)],
        capture_output=True, text=True, timeout=60,
    )
    assert r2.returncode == 0
    assert "GainStats" in r2.stdout


def test_bench_py_json_schema():
    """bench.py is the headline entry point; a schema break there is
    invisible to the suite's own tests. Run its exact code path at toy
    size (8k modes, depth 4) and check the one-JSON-line contract: every
    field a reader of the record relies on, finite and sane, and the
    device it ran on. In-process call (not subprocess) so the conftest's
    8-device CPU mesh config applies (an explicit JAX_PLATFORMS=cpu
    rehearsal)."""
    import importlib
    import io
    import sys as _sys

    _sys.path.insert(0, REPO)
    try:
        bench_mod = importlib.import_module("bench")
    finally:
        _sys.path.pop(0)
    buf = io.StringIO()
    old = _sys.stdout
    _sys.stdout = buf
    try:
        rc = bench_mod.main(n_tracks=8, n_runs=3, warmup=1,
                            pipeline_depth=4)
    finally:
        _sys.stdout = old
    assert rc == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line, got: {lines}"
    rec = json.loads(lines[0])
    assert rec["metric"] == "modal_1M_block_ms"
    assert rec["unit"] == "ms"
    assert rec["validation"] == "passed"
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}
    for key in ("value", "vs_baseline", "blocks_per_sec",
                "saturated_rep_p50_ms", "saturated_rep_min_ms",
                "roundtrip_p50_ms", "roundtrip_p99_ms"):
        assert isinstance(rec[key], (int, float)) and rec[key] > 0, key
    # The headline IS the rep median (VERDICT r3 #6: the reference's
    # percentile discipline, not the flattering min-of-means); the min
    # ships alongside as disclosure and can never exceed it.
    assert rec["value"] == rec["saturated_rep_p50_ms"]
    assert rec["saturated_rep_min_ms"] <= rec["saturated_rep_p50_ms"] * 1.0000001
