"""The results tools stay faithful to the harness JSON: the CSV
derivation round-trips it, and the A/B comparison of two runs gates
only on real regressions."""

import importlib.util
import json
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_json_to_csv_roundtrip(tmp_path):
    """The CSV derivation is faithful: derived columns match the JSON's
    statistics, with and without a saturated tier, and the command line
    writes the same text."""
    conv = _load_tool("json_to_csv")
    with_sat = _synthetic_result()
    without_sat = _synthetic_result()
    without_sat["benchmark"] = "datacopy5050"
    without_sat["deadline"]["meets_deadline"] = False
    del without_sat["saturated"]
    results = [with_sat, without_sat]
    csv_text = conv.convert(results)
    lines = csv_text.strip().split("\n")
    assert len(lines) == len(results) + 1
    header = lines[0].split(",")
    for r, line in zip(results, lines[1:]):
        row = dict(zip(header, line.split(",")))
        assert row["benchmark"] == r["benchmark"]
        assert float(row["p50_ms"]) == pytest.approx(
            r["statistics"]["p50_ms"], rel=1e-5
        )
        assert float(row["p99_ms"]) == pytest.approx(
            r["statistics"]["p99_ms"], rel=1e-5
        )
        meets = row["meets_deadline"] == "true"
        assert meets == r["deadline"]["meets_deadline"]
        sat = r.get("saturated")
        if sat:
            assert float(row["saturated_p50_ms"]) == pytest.approx(
                sat["p50_ms"], rel=1e-5
            )
        else:
            assert row["saturated_p50_ms"] == ""
    src, dst = tmp_path / "r.json", tmp_path / "r.csv"
    src.write_text(json.dumps(results))
    assert conv.main([str(src), str(dst)]) == 0
    assert dst.read_text() == csv_text


def _synthetic_result():
    return {
        "benchmark": "gain",
        "configuration": {"fs": 48000, "bufferSize": 512, "nTracks": 128,
                          "nRuns": 3},
        "statistics": {"min_ms": 1.0, "max_ms": 3.0, "avg_ms": 2.0,
                       "p50_ms": 2.0, "p95_ms": 3.0, "p99_ms": 3.0,
                       "cv_percent": 4.2, "stability": "excellent"},
        "deadline": {"threshold_ms": 10.667, "meets_deadline": True},
        "device_statistics": {"median_ms": 0.0013},
        "saturated": {"p50_ms": 0.11, "p95_ms": 0.12, "p99_ms": 0.13,
                      "blocks_per_sec": 9090.9, "cv_percent": 2.0,
                      "stability": "excellent", "meets_deadline": True},
        "validation": {"max_error": 0.0},
        "metadata": {
            "roofline": {"basis": "device:trace", "achieved_gflops": 50.0,
                         "flops_pct_of_peak": 0.1, "unit": "fp32",
                         "achieved_gbps": 396.0, "hbm_pct_of_peak": 11.8,
                         "bound": "latency",
                         "peak_source": "NVIDIA H100 SXM5 data sheet"},
        },
    }


def test_compare_runs_tool(tmp_path):
    """A/B suite comparison (tools/compare_runs.py): noise-aware
    verdicts, gating only on the chip-meaningful tiers."""
    comp = _load_tool("compare_runs")

    def result(name, dev, sat, rt, sat_cv=2.0):
        return {"benchmark": name,
                "device_statistics": {"median_ms": dev},
                "saturated": {"p50_ms": sat, "cv_percent": sat_cv},
                "statistics": {"p50_ms": rt, "cv_percent": 10.0}}

    old = [result("gain", 0.0013, 0.10, 40.0),
           result("IIRFilter", 0.005, 0.11, 41.0)]
    # gain regresses 50% on saturated; IIR wobbles within its CV.
    new = [result("gain", 0.0013, 0.15, 40.0),
           result("IIRFilter", 0.005, 0.112, 44.0)]
    po, pn = tmp_path / "old.json", tmp_path / "new.json"
    po.write_text(json.dumps(old))
    pn.write_text(json.dumps(new))
    rows, gating = comp.compare(str(po), str(pn))
    verdicts = {(r[0], r[1]): r[5] for r in rows}
    assert verdicts[("gain", "saturated")] == "REGRESSED"
    assert verdicts[("IIRFilter", "saturated")] == "same"
    # round-trip +7.3% sits inside the 10% round-trip CV -> same.
    assert verdicts[("IIRFilter", "roundtrip")] == "same"
    # gain's +50% exceeds WALL_DRIFT_CEILING_PCT, so it gates even
    # though its device tier is unchanged (host-path problem class).
    assert gating == [("gain", "saturated", pytest.approx(50.0))]
    assert comp.main([str(po), str(pn)]) == 1  # gating regression
    assert comp.main([str(po), str(po)]) == 0

    # Saturated slowdown WITHIN the wall-drift ceiling + device tier
    # 'same' -> non-gating wall-drift (the device tier is the witness
    # that the chip ran the identical executable at the same speed).
    drift = [result("gain", 0.0013, 0.115, 40.0)]  # +15%, device same
    pd = tmp_path / "drift.json"
    pd.write_text(json.dumps(drift))
    rows, gating = comp.compare(str(po), str(pd))
    verdicts = {(r[0], r[1]): r[5] for r in rows}
    assert verdicts[("gain", "saturated")] == "wall-drift"
    assert gating == []
    # --strict-wall restores unconditional saturated gating.
    rows, gating = comp.compare(str(po), str(pd), strict_wall=True)
    assert gating == [("gain", "saturated", pytest.approx(15.0))]
    # Device tier IMPROVED is NOT a wall-drift witness: an improved
    # device means the code changed, and a change can add
    # streaming-only work the device tier never sees (--modalRenorm
    # is such a case), so the saturated regression must still gate.
    # (device delta must clear the 1 us absolute floor: 5 -> 3 us)
    faster = [result("IIRFilter", 0.003, 0.1265, 41.0)]  # sat +15%
    pf = tmp_path / "faster.json"
    pf.write_text(json.dumps(faster))
    rows, gating = comp.compare(str(po), str(pf))
    verdicts = {(r[0], r[1]): r[5] for r in rows}
    assert verdicts[("IIRFilter", "device")] == "improved"
    assert verdicts[("IIRFilter", "saturated")] == "REGRESSED"
    assert gating == [("IIRFilter", "saturated", pytest.approx(15.0))]
    # Without a device tier there is no witness: still gates.
    nodev_old = [{"benchmark": "gain",
                  "saturated": {"p50_ms": 0.10, "cv_percent": 2.0}}]
    nodev_new = [{"benchmark": "gain",
                  "saturated": {"p50_ms": 0.115, "cv_percent": 2.0}}]
    pno, pnn = tmp_path / "nodev_old.json", tmp_path / "nodev_new.json"
    pno.write_text(json.dumps(nodev_old))
    pnn.write_text(json.dumps(nodev_new))
    _, gating = comp.compare(str(pno), str(pnn))
    assert gating == [("gain", "saturated", pytest.approx(15.0))]

    # Waiver mechanics: an investigated gating regression can be
    # waived with a reason; the waiver must be consumed (a stale
    # waiver errors) and is surfaced in the row verdict.
    waiver = {("gain", "saturated"): "known host-path cost, issue #X"}
    rows, gating = comp.compare(str(po), str(pn), waivers=waiver)
    verdicts = {(r[0], r[1]): r[5] for r in rows}
    assert verdicts[("gain", "saturated")] == (
        "waived: known host-path cost, issue #X")
    assert gating == []
    with pytest.raises(ValueError, match="unconsumed waiver"):
        comp.compare(str(po), str(po),
                     waivers={("gain", "saturated"): "stale"})
    assert comp.main([str(po), str(pn),
                      "--waive", "gain:saturated:known host cost"]) == 0
    assert comp.main([str(po), str(po),
                      "--waive", "gain:saturated:stale"]) == 2
    assert comp.main([str(po), str(pn), "--waive", "gain:saturated"]) == 2



def test_doctor_checks(monkeypatch):
    """tools/doctor.py: the device probe must answer from a healthy
    CPU backend and must FAIL (not hang) on an unresponsive one; the
    auxiliary checks classify without raising."""
    import importlib.util
    import os as _os

    spec = importlib.util.spec_from_file_location(
        "doctor", _os.path.join(_os.path.dirname(__file__), "..",
                                "tools", "doctor.py"))
    doc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(doc)

    # Scrub PYTHONPATH so the child probes a plain CPU backend.
    monkeypatch.setenv("PYTHONPATH", "")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    status, detail, kind = doc.probe_device(120.0)
    assert status == doc.OK, detail
    assert kind == "cpu"
    # an effectively-zero timeout is indistinguishable from a wedge:
    # the probe must come back as FAIL, never hang
    status, detail, _ = doc.probe_device(0.05)
    assert status == doc.FAIL and "wedged" in detail
    # aux checks return (status, detail) without raising
    for fn, arg in ((doc.check_peaks, kind), (doc.check_peaks, None)):
        s, d = fn(arg)
        assert s in (doc.OK, doc.WARN) and isinstance(d, str)
    assert doc.check_compile_cache()[0] in (doc.OK, doc.WARN)
    assert doc.check_native()[0] in (doc.OK, doc.WARN)
