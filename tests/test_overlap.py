"""Overlapped-infeed tier (--overlapDepth, harness/overlap.py):
double-buffered host->HBM upload against device compute -- SURVEY
§2.4's PP-axis mapping, VERDICT r3 missing #2."""

import pytest

from gpuaudiobench_jax.harness.output import generate_json_results
from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import create_benchmark


@pytest.mark.parametrize("name", [
    "gain", "GainStats", "datacopy5050", "IIRFilter", "Conv1D",
    "Conv1D_accel", "FFT1D", "BiquadChain", "NeuralAmp",
    "DAWSessionMix", "PartConv", "RndMemRead", "DWG1DNaive",
])
def test_overlap_pass_runs_and_validates(small_cfg, name):
    cfg = small_cfg.replace(overlap_depth=4, overlap_reps=2,
                            transfer_mib=1)
    b = create_benchmark(name, cfg)
    b.setup()
    r = run_benchmark(b, cfg, verbose=False)
    assert r.overlap_depth == 4
    assert r.overlap_statistics is not None
    assert r.overlap_serial_statistics is not None
    assert len(r.overlap_latencies) == 2
    assert len(r.overlap_serial_latencies) == 2
    assert r.overlap_statistics.median > 0
    assert r.overlap_serial_statistics.median > 0
    # The overlap pass must not corrupt the benchmark's own validation.
    assert r.validation is None or r.validation.passed

    out = generate_json_results(r, cfg)
    ov = out["overlapped"]
    assert ov["depth"] == 4
    assert ov["overlapped_p50_ms"] > 0 and ov["serial_p50_ms"] > 0
    assert ov["speedup_vs_serial"] == pytest.approx(
        ov["serial_p50_ms"] / ov["overlapped_p50_ms"]
    )


def test_overlap_skipped_without_per_block_upload(small_cfg):
    """Modal synthesis uploads nothing per block; the tier skips
    rather than fabricating an infeed."""
    cfg = small_cfg.replace(overlap_depth=4, overlap_reps=2)
    b = create_benchmark("ModalFilterBank", cfg)
    b.setup()
    assert b.overlap_body() is None
    r = run_benchmark(b, cfg, verbose=False)
    assert r.overlap_statistics is None
    out = generate_json_results(r, cfg)
    assert "overlapped" not in out


def test_overlap_off_by_default(small_cfg):
    b = create_benchmark("gain", small_cfg)
    b.setup()
    r = run_benchmark(b, small_cfg, verbose=False)
    assert r.overlap_statistics is None


def test_datacopy_records_transfer_memory_class(small_cfg):
    """The cudaMallocHost analog is a recorded, measured axis
    (VERDICT r3 missing #1): datacopy metadata says whether pinned_host
    staging is supported and which path the iterations ran."""
    cfg = small_cfg.replace(transfer_mib=1)
    b = create_benchmark("datacopy5050", cfg)
    b.setup()
    b.iterate()
    md = b.metadata()
    tc = md["transferMemoryClass"]
    assert isinstance(tc["pinned_supported"], bool)
    assert tc["h2d_path_used"] in ("pinned", "pageable")
    # Path claim must match reality.
    assert (tc["h2d_path_used"] == "pinned") == \
        (b._pinned_input is not None)
    v = b.validate()
    assert v.passed


def test_overlap_skipped_under_data_parallel(small_cfg):
    """The overlap tier uploads to one chip's HBM; under --dataParallel
    it skips rather than measuring a half-sharded pipeline."""
    cfg = small_cfg.replace(overlap_depth=4, overlap_reps=2,
                            data_parallel=2)
    b = create_benchmark("gain", cfg)
    b.setup()
    r = run_benchmark(b, cfg, verbose=False)
    assert r.overlap_statistics is None
