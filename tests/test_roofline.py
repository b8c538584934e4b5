"""Roofline accounting: per-benchmark cost models, the achieved-rate
computation against the card's published peaks, and the peak table
(utils/roofline.py)."""

import pytest

from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import create_benchmark, list_benchmarks
from gpuaudiobench_jax.utils.roofline import (
    PEAKS,
    UNITS,
    peaks_for,
    roofline_metrics,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_every_benchmark_has_a_cost_model(small_cfg):
    for name in list_benchmarks():
        cfg = small_cfg.replace(transfer_mib=1)
        b = create_benchmark(name, cfg)
        b.setup()
        cost = b.cost_model()
        assert cost is not None, f"{name} lacks a cost model"
        assert cost["hbm_bytes"] > 0
        assert cost["flops"] >= 0
        assert cost["unit"] in UNITS, (name, cost["unit"])


def test_roofline_metrics_math():
    cost = {"flops": 1e9, "hbm_bytes": 3.35e9, "unit": "fp32"}
    rl = roofline_metrics(cost, 1.0, H100)
    assert rl["achieved_gflops"] == pytest.approx(1000.0)
    assert rl["achieved_gbps"] == pytest.approx(3350.0)
    # 3.35e9 bytes in 1 ms = 3.35 TB/s = 100% of the H100's HBM peak
    assert rl["hbm_pct_of_peak"] == pytest.approx(100.0)
    assert rl["flops_pct_of_peak"] == pytest.approx(100.0 * 1e12 / 67e12)
    assert rl["bound"] == "bandwidth"
    assert rl["peak_source"].startswith("NVIDIA H100")
    with pytest.raises(ValueError):
        roofline_metrics(cost, 0.0, H100)


@pytest.mark.parametrize("unit,peak", [("fp32", 67e12), ("tf32", 495e12),
                                       ("bf16", 989e12), ("int8", 1979e12)])
def test_share_is_taken_against_the_unit_peak(unit, peak):
    """The same achieved rate is a different share of each unit's peak:
    1 PFLOP in 1 s is 100% of whichever peak the cost names."""
    cost = {"flops": peak / 1e3, "hbm_bytes": 1.0, "unit": unit}
    rl = roofline_metrics(cost, 1.0, H100)
    assert rl["flops_pct_of_peak"] == pytest.approx(100.0)
    assert rl["bound"] == "compute"


def test_peak_table_holds_the_published_h100_numbers():
    p = peaks_for(H100)
    assert (p["fp32"], p["tf32"], p["bf16"], p["int8"]) == (
        67e12, 495e12, 989e12, 1979e12)
    assert p["hbm_bytes_per_sec"] == 3.35e12
    assert "data sheet" in p["source"]
    assert set(UNITS) <= set(p)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200",
                                  ""])
def test_unknown_device_is_an_error(kind):
    """A card not in the table raises; no other card's peaks stand in."""
    assert kind not in PEAKS
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for(kind)
    with pytest.raises(KeyError):
        roofline_metrics({"flops": 1, "hbm_bytes": 1, "unit": "fp32"}, 1.0,
                         kind)


def test_unknown_unit_is_an_error():
    with pytest.raises(ValueError, match="unknown cost unit"):
        roofline_metrics({"flops": 1, "hbm_bytes": 1, "unit": "mxu"}, 1.0,
                         H100)


def test_unsaturated_rows_are_latency_bound():
    """A row where every wall is below the threshold must not claim
    X-bound -- it reports 'latency' and keeps the nearest wall as a
    labeled ranking, never the headline."""
    cost = {"flops": 8e6, "hbm_bytes": 31e6, "unit": "fp32"}
    rl = roofline_metrics(cost, 1.0, H100)
    assert rl["hbm_pct_of_peak"] < 20.0
    assert rl["flops_pct_of_peak"] < 20.0
    assert rl["bound"] == "latency"
    assert rl["nearest_wall"] == "bandwidth"
    assert rl["nearest_wall_pct"] == pytest.approx(rl["hbm_pct_of_peak"])

    # At/above the threshold the wall label is legitimate.
    cost = {"flops": 1e9, "hbm_bytes": 3.35e9, "unit": "fp32"}
    rl = roofline_metrics(cost, 1.0, H100)
    assert rl["bound"] == "bandwidth"
    assert rl["nearest_wall"] == "bandwidth"


def test_runner_roofline_gated_on_gpu(small_cfg, monkeypatch):
    """The CPU has no published peaks, so CPU runs carry no roofline;
    on a GPU the runner computes it against the card's own entry."""
    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2)
    b = create_benchmark("gain", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    assert "roofline" not in result.metadata  # CPU backend

    from gpuaudiobench_jax.utils import device as dev

    # The CPU device posing as a card in the table.
    monkeypatch.setattr(dev, "platform", lambda: "gpu")
    monkeypatch.setitem(PEAKS, "cpu", PEAKS[H100])
    b2 = create_benchmark("gain", cfg)
    b2.setup()
    result = run_benchmark(b2, cfg, verbose=False)
    rl = result.metadata["roofline"]
    assert rl["basis"] in ("saturated-marginal", "saturated")
    assert rl["achieved_gbps"] > 0
    assert rl["peak_source"] == PEAKS[H100]["source"]


def test_gainstats_cost_within_gain(small_cfg):
    """GainStats is an elementwise op plus a trivial row reduction --
    its algorithmic cost model must sit within ~1.5x of gain's traffic
    so a large measured gap flags an implementation problem, not a
    workload difference."""
    g = create_benchmark("gain", small_cfg)
    g.setup()
    gs = create_benchmark("GainStats", small_cfg)
    gs.setup()
    ratio = gs.cost_model()["hbm_bytes"] / g.cost_model()["hbm_bytes"]
    assert 1.0 <= ratio < 1.5


@pytest.mark.gpu
def test_runner_roofline_on_the_card(gpu_device, small_cfg):
    cfg = small_cfg.replace(device_timing=True)
    b = create_benchmark("gain", cfg)
    b.setup()
    rl = run_benchmark(b, cfg, verbose=False).metadata["roofline"]
    assert rl["basis"] == "device:trace"
    assert rl["peak_source"] == peaks_for(gpu_device.device_kind)["source"]
