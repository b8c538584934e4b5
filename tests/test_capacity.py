"""tools/capacity.py: real-time capacity search.

The search core is tested exhaustively against synthetic monotone
oracles (no hardware in the loop); one smoke test drives the real
harness end-to-end at toy sizes on the CPU backend.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from capacity import knob_for, quantize, search_capacity  # noqa: E402


def oracle(threshold):
    """Monotone pass/fail: sustains iff value <= threshold."""
    return lambda v: v <= threshold


def test_finds_exact_quantized_capacity():
    # threshold 5000, quantum 128: largest passing multiple is 4992.
    cap, probes, ceiling = search_capacity(
        oracle(5000), lo=128, hi=128 * 512, quantum=128, max_evals=30)
    assert cap == 4992
    assert not ceiling
    # every probe respected monotonicity bookkeeping
    assert all(ok == (v <= 5000) for v, ok in probes)


def test_lo_fails_means_no_capacity():
    cap, probes, ceiling = search_capacity(
        oracle(0), lo=128, hi=1024, quantum=128, max_evals=10)
    assert cap is None
    assert probes == [(128, False)]
    assert not ceiling


def test_hi_passes_flags_ceiling():
    cap, probes, ceiling = search_capacity(
        oracle(10**9), lo=128, hi=1024, quantum=128, max_evals=10)
    assert cap == 1024
    assert ceiling


def test_probe_budget_is_respected():
    calls = []

    def ev(v):
        calls.append(v)
        return v <= 100_000

    cap, probes, _ = search_capacity(
        ev, lo=128, hi=1 << 20, quantum=128, max_evals=5)
    assert len(calls) <= 5
    assert cap is not None  # best certified value under the budget
    assert cap <= 100_000


def test_capacity_exactly_on_quantum_boundary():
    cap, _, _ = search_capacity(
        oracle(2048), lo=128, hi=8192, quantum=128, max_evals=30)
    assert cap == 2048


def test_misaligned_bounds_rejected():
    with pytest.raises(ValueError):
        search_capacity(oracle(10), lo=100, hi=1000, quantum=128,
                        max_evals=5)
    with pytest.raises(ValueError):
        search_capacity(oracle(10), lo=256, hi=128, quantum=128,
                        max_evals=5)


def test_quantize():
    assert quantize(5000, 128, 128) == 4992
    assert quantize(100, 128, 128) == 128  # floors to lo


def test_knob_map():
    assert knob_for("ModalFilterBank")[0] == "modal_num_modes"
    assert knob_for("gain")[0] == "n_tracks"
    assert knob_for("FDTD3D")[0] == "fdtd_room"  # --fdtdRoom load axis
    with pytest.raises(SystemExit):
        knob_for("SOL_FMA_f32")
    with pytest.raises(SystemExit):
        knob_for("datacopy5050")  # no saturated tier to judge by


def test_probe_exception_counts_as_infeasible(tmp_path, monkeypatch):
    """A probe that raises (OOM at a boundary size) is a miss, not a
    crash: the search still returns the best certified value."""
    import capacity as cap

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        def evaluate(value):
            if value > 256:
                raise MemoryError("RESOURCE_EXHAUSTED (simulated)")
            return True, {"value": value, "saturated_p50_ms": 0.1,
                          "saturated_p99_ms": 0.1, "valid": True,
                          "device_p50_ms": 0.05}
        return evaluate

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out = tmp_path / "cap.json"
    rc = cap.main([
        "--benchmark", "gain", "--lo", "128", "--hi", "1024",
        "--quantum", "128", "--maxEvals", "8", "--json", str(out),
    ])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["capacity"] == 256
    assert any("error" in p for p in rec["probes"])
    # The bounding probe raised RESOURCE_EXHAUSTED, so the record must
    # disclose a memory wall, not imply a deadline-bound capacity.
    assert rec["wall_class"] == "memory"
    md = cap.render_md([rec])
    assert "memory wall" in md


def test_classify_wall():
    from capacity import classify_wall

    assert classify_wall(
        "INTERNAL: CUDA_ERROR_OUT_OF_MEMORY: out of memory") == "memory"
    assert classify_wall("RESOURCE_EXHAUSTED: alloc") == "memory"
    assert classify_wall("Out of memory allocating 8G") == "memory"
    assert classify_wall("something else entirely") == "error"


def test_deadline_wall_class(tmp_path, monkeypatch):
    """A probe that RUNS and misses p99 bounds a genuine deadline
    wall; the record says so (wall_class='deadline')."""
    import capacity as cap

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        def evaluate(value):
            p99 = 0.1 if value <= 256 else 99.0
            return p99 <= 10.667, {
                "value": value, "saturated_p50_ms": p99,
                "saturated_p99_ms": p99, "valid": True,
                "device_p50_ms": p99 / 2}
        return evaluate

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out = tmp_path / "cap.json"
    rc = cap.main([
        "--benchmark", "gain", "--lo", "128", "--hi", "1024",
        "--quantum", "128", "--maxEvals", "8", "--json", str(out),
    ])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["capacity"] == 256
    assert rec["wall_class"] == "deadline"
    assert "wall" not in cap.render_md([rec])


def test_modal_skips_golden_when_verification_none():
    """verification='none' must not pay the host golden (linear in
    modes; the whole point of fast capacity probes)."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = BenchConfig(n_runs=1, warmup=1, verification="none",
                      modal_num_modes=1024, write_latencies=False,
                      quiet=True, device_timing=False)
    b = create_benchmark("ModalFilterBank", cfg)
    b.setup()
    assert b.golden is None
    r = run_benchmark(b, cfg, verbose=False)
    assert r.validation is not None
    assert r.validation.passed  # SKIPPED counts as non-failure


def test_multi_benchmark_md_table(tmp_path, monkeypatch):
    """Several --benchmark flags produce a list JSON + markdown table
    using per-benchmark default ranges."""
    import capacity as cap

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        limit = 100_000 if field == "modal_num_modes" else 1000
        return lambda v: (v <= limit, {
            "value": v, "saturated_p50_ms": 0.5, "saturated_p99_ms": 0.6,
            "valid": True, "device_p50_ms": 0.4})

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out_json = tmp_path / "caps.json"
    out_md = tmp_path / "caps.md"
    rc = cap.main([
        "--benchmark", "ModalFilterBank", "--benchmark", "IIRFilter",
        "--maxEvals", "30",
        "--json", str(out_json), "--md", str(out_md),
    ])
    assert rc == 0
    recs = json.loads(out_json.read_text())
    assert [r["benchmark"] for r in recs] == ["ModalFilterBank",
                                              "IIRFilter"]
    assert recs[0]["knob"] == "modal_num_modes"
    assert recs[0]["capacity"] == 99_328   # largest 1024-multiple <= 100k
    assert recs[1]["capacity"] == 896      # largest 128-multiple <= 1000
    md = out_md.read_text()
    assert "| ModalFilterBank |" in md and "| IIRFilter |" in md
    assert "99328" in md and "896" in md


def test_multi_benchmark_rejects_explicit_bounds(tmp_path):
    from capacity import main

    with pytest.raises(SystemExit):
        main(["--benchmark", "gain", "--benchmark", "IIRFilter",
              "--lo", "128"])


def test_end_to_end_gain_cpu(tmp_path):
    """Full tool path at toy sizes: gain trivially sustains the
    10.67 ms deadline on any backend, so the search must hit the
    ceiling and the JSON record must carry the confirmation run."""
    from capacity import main

    out = tmp_path / "cap.json"
    rc = main([
        "--benchmark", "gain", "--lo", "64", "--hi", "128",
        "--quantum", "64", "--maxEvals", "4", "--nRuns", "2",
        "--warmup", "1", "--pipelineDepth", "8", "--satReps", "3",
        "--json", str(out),
    ])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["capacity"] == 128
    assert rec["ceiling_hit"] is True
    assert rec["knob"] == "n_tracks"
    assert rec["deadline_ms"] == pytest.approx(1000.0 * 512 / 48000)
    assert rec["confirmation"]["valid"] is True
    assert rec["confirmation"]["saturated_p99_ms"] is not None
    # the confirmation run re-enables device timing
    assert "device_p50_ms" in rec["confirmation"]
    assert all(p["valid"] for p in rec["probes"])


def test_merge_capacity_groups_by_deadline(tmp_path):
    from merge_capacity import main as merge_main

    rec = {
        "benchmark": "gain", "knob": "n_tracks", "capacity": 512,
        "ceiling_hit": False, "deadline_ms": 10.667, "margin": 0.0,
        "buffer_size": 512, "fs": 48000, "pipeline_depth": 256,
        "saturated_reps": 11, "probes": [],
        "confirmation": {"saturated_p50_ms": 1.0, "saturated_p99_ms": 1.2,
                         "device_p50_ms": 0.9, "valid": True},
    }
    rec64 = dict(rec, benchmark="ModalFilterBank", buffer_size=64,
                 deadline_ms=64000 / 48000, capacity=65536,
                 knob="modal_num_modes")
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(rec))
    b.write_text(json.dumps([rec64]))  # list form merges too
    out = tmp_path / "merged.md"
    rc = merge_main([str(out), str(a), str(b)])
    assert rc == 0
    md = out.read_text()
    assert md.count("# Real-time capacity") == 2  # one table per deadline
    assert "| gain |" in md and "| ModalFilterBank |" in md
    assert "buffer 64" in md and "buffer 512" in md


def test_budget_exhaustion_is_disclosed(tmp_path, monkeypatch):
    """If the budget runs out during the ascent (no miss observed, hi
    not reached), the record must say the capacity is a lower bound."""
    import capacity as cap

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        return lambda v: (True, {"value": v, "saturated_p50_ms": 0.1,
                                 "saturated_p99_ms": 0.1, "valid": True,
                                 "device_p50_ms": 0.05})

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out = tmp_path / "cap.json"
    rc = cap.main([
        "--benchmark", "gain", "--lo", "128", "--hi", str(128 * 1024),
        "--quantum", "128", "--maxEvals", "3", "--json", str(out),
    ])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["budget_exhausted"] is True
    assert rec["ceiling_hit"] is False
    assert rec["capacity"] == 512  # 128 -> 256 -> 512, budget spent


def test_budget_exhaustion_mid_bisection_is_disclosed(tmp_path,
                                                      monkeypatch):
    """If a miss WAS observed but the budget ran out before bisection
    narrowed the boundary to --quantum, the record must still disclose
    the capacity as a lower bound, with the unrefined gap."""
    import capacity as cap

    threshold = 5000  # passes 128..4096, fails 8192; budget of 7
    # probes spends 128/256/512/1024/2048/4096/8192 on the ascent and
    # leaves the (4096, 8192) gap unbisected.

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        def probe(v):
            ok = v <= threshold
            return ok, {"value": v, "saturated_p50_ms": 0.1,
                        "saturated_p99_ms": 0.1 if ok else 99.0,
                        "valid": True, "device_p50_ms": 0.05}
        return probe

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out = tmp_path / "cap.json"
    rc = cap.main([
        "--benchmark", "gain", "--lo", "128", "--hi", str(128 * 1024),
        "--quantum", "128", "--maxEvals", "7", "--json", str(out),
    ])
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["capacity"] == 4096
    assert rec["budget_exhausted"] is True
    assert rec["boundary_gap"] == 8192 - 4096
    md = cap.render_md([rec])
    assert ">= only (budget; boundary gap 4096)" in md


def test_search_matches_exhaustive_scan_randomized():
    """Property: with a generous budget, the search returns exactly the
    largest grid value passing a monotone oracle, for random
    thresholds/bounds/quanta."""
    import random

    rng = random.Random(1234)
    for _ in range(200):
        quantum = rng.choice([1, 16, 128, 1024])
        lo = quantum * rng.randint(1, 8)
        hi = lo + quantum * rng.randint(1, 512)
        threshold = rng.randint(0, hi + quantum)
        cap, probes, ceiling = search_capacity(
            oracle(threshold), lo, hi, quantum, max_evals=64)
        grid = range(lo, hi + 1, quantum)
        expected = max((v for v in grid if v <= threshold), default=None)
        assert cap == expected, (lo, hi, quantum, threshold)
        if expected is not None:
            assert ceiling == (expected == hi and hi <= threshold)


def test_set_overrides_parse_and_render():
    """--set FIELD=VALUE coerces to the dataclass type, rejects
    unknown fields, lands in the record, and renders in the note."""
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import capacity as cap

    ov = cap.parse_overrides(
        ["partconv_form=nupols", "partconv_tail_chunk=16",
         "modal_renorm=true"])
    assert ov == {"partconv_form": "nupols", "partconv_tail_chunk": 16,
                  "modal_renorm": True}
    assert isinstance(ov["partconv_tail_chunk"], int)
    with pytest.raises(SystemExit, match="unknown BenchConfig field"):
        cap.parse_overrides(["not_a_field=1"])
    with pytest.raises(SystemExit, match="FIELD=VALUE"):
        cap.parse_overrides(["oops"])

    rec = {
        "benchmark": "PartConv", "knob": "n_tracks", "capacity": 128,
        "ceiling_hit": False, "budget_exhausted": False,
        "deadline_ms": 10.667, "buffer_size": 512, "fs": 48000,
        "config_overrides": {"partconv_form": "nupols"},
        "confirmation": {"saturated_p50_ms": 1.0,
                         "saturated_p99_ms": 1.1, "device_p50_ms": 0.9},
    }
    fd, tmp = tempfile.mkstemp(suffix=".md")
    os.close(fd)
    try:
        cap.render_md([rec], tmp)
        text = open(tmp).read()
    finally:
        os.unlink(tmp)
    assert "partconv_form=nupols" in text


def test_knob_override_requires_range_and_real_field():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import capacity as cap

    class A:  # minimal args stand-in
        knob = "ir_length"
        lo = hi = quantum = None
        set = []

    with pytest.raises(SystemExit, match="--lo/--hi/--quantum"):
        cap.run_one("PartConv", A)
    A.lo, A.hi, A.quantum = 1, 2, 1
    A.knob = "no_such_field"
    with pytest.raises(SystemExit, match="unknown BenchConfig field"):
        cap.run_one("PartConv", A)


def test_partial_trace_flushed_and_superseded(tmp_path, monkeypatch):
    """Every probe persists the trace-so-far to <json>.partial (a
    batch-timeout SIGTERM mid-bisection must not lose hours of probe
    evidence); successful completion removes it in favor of the real
    record."""
    import capacity as cap

    partial = tmp_path / "cap.json.partial"
    seen_probe_counts = []

    def fake_harness_probe(benchmark, field, args, device_timing=False):
        def evaluate(value):
            # The partial written by the PREVIOUS probe is on disk
            # before this one runs (n-1 entries at probe n).
            if partial.exists():
                seen_probe_counts.append(
                    len(json.loads(partial.read_text())["probes"]))
            return value <= 256, {"value": value, "saturated_p50_ms": 0.1,
                                  "saturated_p99_ms": 0.1, "valid": True,
                                  "device_p50_ms": 0.05}
        return evaluate

    monkeypatch.setattr(cap, "harness_probe", fake_harness_probe)
    out = tmp_path / "cap.json"
    rc = cap.main([
        "--benchmark", "gain", "--lo", "128", "--hi", "1024",
        "--quantum", "128", "--maxEvals", "8", "--json", str(out),
    ])
    assert rc == 0
    # incremental: later probes saw earlier probes' flushed traces
    assert seen_probe_counts and seen_probe_counts == sorted(seen_probe_counts)
    # superseded: the real record exists, the partial is gone
    assert out.exists() and not partial.exists()
