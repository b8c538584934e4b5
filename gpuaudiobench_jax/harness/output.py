"""Result printing and CSV/JSON/latency-file writers.

CSV schema and truncated-index percentiles reproduce cuda/globals.cu:
69-122 exactly (header `benchmark,fs,bufferSize,nTracks,nRuns,min_ms,
max_ms,avg_ms,p50_ms,p95_ms,p99_ms,threshold_ms,meets_deadline`,
append-with-header-detection, meets_deadline = p99 <= 1000*BUFSIZE/FS).
JSON matches globals.cu:137-182's structure with additional metadata
sections (device/validation) in the spirit of the Metal JSON writer
(main.swift:323-359). The latencies file ports
bench_utils.cu:416-442.
"""

from __future__ import annotations

import json
import os

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.base import BenchmarkResult
from gpuaudiobench_jax.harness.statistics import csv_percentile
from gpuaudiobench_jax.harness.validation import ValidationStatus

CSV_HEADER = (
    "benchmark,fs,bufferSize,nTracks,nRuns,min_ms,max_ms,avg_ms,"
    "p50_ms,p95_ms,p99_ms,threshold_ms,meets_deadline"
)
# Extension columns emitted when --pipelineDepth is active: marginal
# per-block latency with the dispatch pipeline kept full (p50/p95/p99
# over saturated_reps runs -- the reference's percentile discipline,
# globals.cu:101-122, applied to the chip-meaningful tier), reciprocal
# throughput, and a saturation-tier deadline verdict (p99 basis, like
# the round-trip meets_deadline). Blank for benchmarks without a
# streaming mode.
CSV_SATURATED_COLS = (
    ",saturated_p50_ms,saturated_p95_ms,saturated_p99_ms"
    ",blocks_per_sec,saturated_meets_deadline"
)
# Marginal extension: the saturated_* columns above are AMORTIZED
# wall/depth of one chained executable, which includes the fixed
# dispatch + readback cost divided by the depth. When the marginal tier
# ran (cfg.saturated_marginal), these columns carry the
# depth-differenced marginal per-block cost (fixed costs cancelled) and
# name the basis blocks_per_sec derives from ("marginal" when the
# marginal p50 resolved above timer noise, else "amortized").
CSV_MARGINAL_COLS = ",saturated_marginal_p50_ms,blocks_per_sec_basis"
# Context columns that make the CSV self-contained. Always emitted:
#   device_timing_method -- how device numbers for this row were
#     obtained (blank when the device pass was off);
#   platform, device_kind, device_count -- the device the row ran on,
#     so a CPU rehearsal can never be read as a GPU measurement.
CSV_CONTEXT_COLS = ",device_timing_method,platform,device_kind,device_count"


def _csv_stats(latencies, cfg: BenchConfig):
    svec = sorted(latencies)
    n = len(svec)
    mn = svec[0] if n else 0.0
    mx = svec[-1] if n else 0.0
    avg = sum(latencies) / n if n else 0.0
    p50 = csv_percentile(svec, 0.50)
    p95 = csv_percentile(svec, 0.95)
    p99 = csv_percentile(svec, 0.99)
    threshold = cfg.deadline_ms()
    return mn, mx, avg, p50, p95, p99, threshold


def _saturated_derived(result: BenchmarkResult):
    """(sat_p50, marginal_p50 | None, blocks_per_sec, basis) -- ONE
    derivation shared by the CSV writer and the JSON generator so the
    two surfaces cannot disagree on what ``blocks_per_sec`` means.
    blocks_per_sec comes from the marginal per-block cost when the
    marginal tier ran and resolved above timer noise (> 0), else from
    the amortized wall/depth, and the basis label says which."""
    svec = sorted(result.saturated_latencies)
    sat_p50 = csv_percentile(svec, 0.50)
    marg_p50 = None
    if result.saturated_marginal_statistics is not None:
        mvec = sorted(result.saturated_marginal_latencies)
        marg_p50 = csv_percentile(mvec, 0.50)
    if marg_p50 is not None and marg_p50 > 0:
        return sat_p50, marg_p50, 1000.0 / marg_p50, "marginal"
    bps = 1000.0 / sat_p50 if sat_p50 > 0 else 0.0
    return sat_p50, marg_p50, bps, "amortized"


# Metal's alternate CSV schema (metal-swift/.../main.swift:256,320).
METAL_CSV_HEADER = (
    "benchmark,median_ms,p95_ms,p99_ms,max_ms,mean_ms,stddev_ms,count"
)


def _check_existing_header(filename: str, expected: str) -> bool:
    """Appending rows under a different header silently corrupts the
    CSV (e.g. a --pipelineDepth run after a plain run, or --csvSchema
    metal into a cuda-schema file). Returns True when a header must be
    written; raises on mismatch with an existing one."""
    if not os.path.exists(filename):
        return True
    with open(filename) as f:
        first = f.readline().rstrip("\n")
    if first and first != expected:
        raise ValueError(
            f"{filename} already has a different CSV schema "
            f"(found {first.split(',')[0]}...-header with "
            f"{len(first.split(','))} columns, this run writes "
            f"{len(expected.split(','))}); use a new --outputfile"
        )
    return not first


def write_csv_results(result: BenchmarkResult, cfg: BenchConfig, filename: str) -> None:
    if not filename:
        return
    if cfg.csv_schema == "metal":
        s = result.statistics
        write_header = _check_existing_header(filename, METAL_CSV_HEADER)
        with open(filename, "a") as f:
            if write_header:
                f.write(METAL_CSV_HEADER + "\n")
            f.write(
                f"{result.benchmark_name},{s.median:g},{s.p95:g},{s.p99:g},"
                f"{s.max_val:g},{s.mean:g},{s.std_dev:g},{s.count}\n"
            )
        print(f"Results saved to: {filename}")
        return
    mn, mx, avg, p50, p95, p99, threshold = _csv_stats(result.latencies, cfg)
    meets = p99 <= threshold
    saturated_mode = cfg.pipeline_depth > 1
    marginal_mode = (saturated_mode and cfg.saturated_marginal
                     and cfg.pipeline_depth >= 4)
    extra = ""
    if saturated_mode:
        if result.saturated_statistics is not None and \
                result.saturated_statistics.median > 0:
            svec_sat = sorted(result.saturated_latencies)
            sat_p50, marg_p50, bps, basis = _saturated_derived(result)
            sat_p95 = csv_percentile(svec_sat, 0.95)
            sat_p99 = csv_percentile(svec_sat, 0.99)
            sat_meets = "true" if sat_p99 <= threshold else "false"
            extra = (
                f",{sat_p50:g},{sat_p95:g},{sat_p99:g}"
                f",{bps:g},{sat_meets}"
            )
            if marginal_mode:
                marg_s = f"{marg_p50:g}" if marg_p50 is not None else ""
                extra += f",{marg_s},{basis}"
        else:
            extra = ",,,,," + (",," if marginal_mode else "")
    # Context columns (see CSV_CONTEXT_COLS).
    method = result.device_timing_method or ""
    from gpuaudiobench_jax.utils.device import device_record

    d = device_record()
    extra += f",{method},{d['platform']},{d['kind']},{d['count']}"
    header = (CSV_HEADER + (CSV_SATURATED_COLS if saturated_mode else "")
              + (CSV_MARGINAL_COLS if marginal_mode else "")
              + CSV_CONTEXT_COLS)
    write_header = _check_existing_header(filename, header)
    with open(filename, "a") as f:
        if write_header:
            f.write(header + "\n")
        f.write(
            f"{result.benchmark_name},{cfg.fs},{cfg.buffer_size},{cfg.n_tracks},"
            f"{len(result.latencies)},{mn:g},{mx:g},{avg:g},{p50:g},{p95:g},"
            f"{p99:g},{threshold:g},{'true' if meets else 'false'}{extra}\n"
        )
    print(f"Results saved to: {filename}")


def csv_from_json_results(results: list) -> str:
    """Canonical JSON->CSV derivation (one measurement, two
    serializations): the CUDA schema (globals.cu:69-122) plus the
    saturated extension columns plus the always-present context columns
    (CSV_CONTEXT_COLS). tools/json_to_csv.py and the web UI's
    /api/export.csv both delegate here so the three CSV surfaces can
    never drift."""
    saturated_mode = any(r.get("saturated") for r in results)
    # Marginal columns appear only when some JSON actually carries the
    # marginal tier (r5+), so pre-r5 artifacts re-derive byte-identically.
    marginal_mode = any(
        (r.get("saturated") or {}).get("marginal") for r in results
    )
    header = (CSV_HEADER + (CSV_SATURATED_COLS if saturated_mode else "")
              + (CSV_MARGINAL_COLS if marginal_mode else "")
              + CSV_CONTEXT_COLS)
    lines = [header]
    for r in results:
        c, s, d = r["configuration"], r["statistics"], r["deadline"]
        row = (
            f'{r["benchmark"]},{c["fs"]},{c["bufferSize"]},{c["nTracks"]},'
            f'{c["nRuns"]},{s["min_ms"]:g},{s["max_ms"]:g},{s["avg_ms"]:g},'
            f'{s["p50_ms"]:g},{s["p95_ms"]:g},{s["p99_ms"]:g},'
            f'{d["threshold_ms"]:g},'
            f'{"true" if d["meets_deadline"] else "false"}'
        )
        if saturated_mode:
            sat = r.get("saturated")
            if sat and sat.get("p50_ms", 0) > 0:
                # p95/p99 may be absent in pre-r3 JSONs.
                p95 = sat.get("p95_ms")
                p99 = sat.get("p99_ms")
                meets = sat.get("meets_deadline")
                row += f',{sat["p50_ms"]:g}'
                row += f",{p95:g}" if p95 is not None else ","
                row += f",{p99:g}" if p99 is not None else ","
                row += f',{sat["blocks_per_sec"]:g}'
                row += ("," + ("true" if meets else "false")
                        if meets is not None else ",")
                if marginal_mode:
                    marg = sat.get("marginal")
                    if marg:
                        row += (f',{marg["p50_ms"]:g}'
                                f',{sat.get("blocks_per_sec_basis", "")}')
                    else:
                        row += ",,"
            else:
                row += ",,,,," + (",," if marginal_mode else "")
        method = (r.get("device_statistics") or {}).get("method") or ""
        d = r.get("device") or {}
        row += (f",{method},{d.get('platform', '')},{d.get('kind', '')}"
                f",{d.get('count', '')}")
        lines.append(row)
    return "\n".join(lines) + "\n"


def generate_json_results(result: BenchmarkResult, cfg: BenchConfig) -> dict:
    mn, mx, avg, p50, p95, p99, threshold = _csv_stats(result.latencies, cfg)
    out = {
        "benchmark": result.benchmark_name,
        "configuration": {
            "fs": cfg.fs,
            "bufferSize": cfg.buffer_size,
            "nTracks": cfg.n_tracks,
            "nRuns": len(result.latencies),
        },
        "statistics": {
            "min_ms": mn,
            "max_ms": mx,
            "avg_ms": avg,
            "p50_ms": p50,
            "p95_ms": p95,
            "p99_ms": p99,
        },
        "deadline": {
            "threshold_ms": threshold,
            "meets_deadline": bool(p99 <= threshold),
        },
    }
    # Extended sections beyond the CUDA schema (Metal-style metadata).
    from gpuaudiobench_jax.harness.statistics import (
        detect_outliers,
        stability_rating,
    )

    s = result.statistics
    cv, rating = stability_rating(result.latencies)
    outliers, _, _ = detect_outliers(result.latencies)
    out["statistics"].update(
        {
            "median_ms": s.median,
            "stddev_ms": s.std_dev,
            "cv_percent": cv,
            "stability": rating,
            "outlier_count": len(outliers),
        }
    )
    if result.device_statistics is not None:
        d = result.device_statistics
        out["device_statistics"] = {
            "median_ms": d.median,
            "p95_ms": d.p95,
            "p99_ms": d.p99,
            "mean_ms": d.mean,
            "min_ms": d.min_val,
            "max_ms": d.max_val,
            "method": result.device_timing_method,
        }
    if result.saturated_statistics is not None:
        ss = result.saturated_statistics
        svec_sat = sorted(result.saturated_latencies)
        sat_p50, _marg_p50, bps, bps_basis = _saturated_derived(result)
        sat_p95 = csv_percentile(svec_sat, 0.95)
        sat_p99 = csv_percentile(svec_sat, 0.99)
        sat_cv, sat_rating = stability_rating(result.saturated_latencies)
        out["saturated"] = {
            "pipeline_depth": result.pipeline_depth,
            # p50/p95/p99/mean/min are the AMORTIZED tier: wall/depth of
            # one chained executable, including the fixed dispatch +
            # readback cost / depth -- see "marginal" below for the
            # per-block cost with that floor cancelled.
            "p50_ms": sat_p50,
            "p95_ms": sat_p95,
            "p99_ms": sat_p99,
            "mean_ms": ss.mean,
            "min_ms": ss.min_val,
            "amortized_note": (
                "p50/p95/p99 are wall/depth of one chained executable "
                "(includes any fixed sync floor divided by the depth); "
                "'marginal' is the depth-differenced per-block cost "
                "with that floor cancelled"
            ),
            # Derived from the marginal tier when it ran and resolved
            # above timer noise; basis says which (wall/depth
            # understates the device's rate for µs-scale bodies).
            "blocks_per_sec": bps,
            "blocks_per_sec_basis": bps_basis,
            "reps": ss.count,
            "cv_percent": sat_cv,
            "stability": sat_rating,
            # p99 basis: the same percentile discipline the round-trip
            # meets_deadline applies (globals.cu:101-122). Amortized
            # (conservative: includes the fixed-cost share).
            "meets_deadline": bool(sat_p99 <= cfg.deadline_ms()),
            # Raw per-rep values (the round-trip tier already ships
            # raw_latencies_ms): lets a reader attribute a poor CV to
            # one outlier vs genuine spread.
            "raw_ms": [round(v, 6) for v in result.saturated_latencies],
        }
        if result.saturated_marginal_statistics is not None:
            ms = result.saturated_marginal_statistics
            mvec = sorted(result.saturated_marginal_latencies)
            out["saturated"]["marginal"] = {
                # (wall(depth) - wall(lo_depth)) / (depth - lo_depth),
                # interleaved reps (streaming.measure_saturated_marginal).
                "lo_depth": result.saturated_lo_depth,
                "p50_ms": csv_percentile(mvec, 0.50),
                "p95_ms": csv_percentile(mvec, 0.95),
                "mean_ms": ms.mean,
                "min_ms": ms.min_val,
                # Raw per-rep marginals; sub-noise bodies may difference
                # slightly negative -- reported raw, never clamped here.
                "raw_ms": [round(v, 6)
                           for v in result.saturated_marginal_latencies],
            }
    if result.overlap_statistics is not None:
        os_, ov = result.overlap_serial_statistics, result.overlap_statistics
        sp = os_.median / ov.median if ov.median > 0 else 0.0
        out["overlapped"] = {
            "depth": result.overlap_depth,
            # Serial twin: upload -> compute -> sync per block.
            "serial_p50_ms": os_.median,
            "overlapped_p50_ms": ov.median,
            "overlapped_p95_ms": ov.p95,
            "speedup_vs_serial": sp,
            "reps": ov.count,
            "serial_raw_ms": [round(v, 6)
                              for v in result.overlap_serial_latencies],
            "overlapped_raw_ms": [round(v, 6)
                                  for v in result.overlap_latencies],
            "meets_deadline": bool(ov.p95 <= cfg.deadline_ms()),
        }
    out["performance"] = {
        "throughput_gbps": result.throughput_gbps,
        "samples_per_sec": result.samples_per_sec,
        "bytes_processed": result.bytes_processed,
    }
    if result.validation is not None:
        out["validation"] = {
            "status": result.validation.status.value,
            "max_error": result.validation.max_error,
            "mean_error": result.validation.mean_error,
            "error_count": result.validation.error_count,
            "samples_checked": result.validation.samples_checked,
        }
    if result.deadline_miss_rate is not None:
        out["deadline"]["miss_rate_percent"] = result.deadline_miss_rate
    from gpuaudiobench_jax.utils.device import device_record

    out["device"] = device_record()  # Metal JSON parity: device identity
    if result.metadata:
        out["metadata"] = result.metadata
    # Raw per-iteration latencies (extension: feeds tools/report.py
    # histograms, the Chart.js analog).
    out["raw_latencies_ms"] = [round(v, 6) for v in result.latencies]
    return out


def write_json_results(
    result: BenchmarkResult, cfg: BenchConfig, filename: str = ""
) -> None:
    payload = json.dumps(generate_json_results(result, cfg), indent=2)
    if not filename:
        print(payload)
        return
    with open(filename, "w") as f:
        f.write(payload)
    print(f"JSON results saved to: {filename}")


def write_latencies_file(result: BenchmarkResult, filename: str = "") -> None:
    """Raw latency dump with stats header (bench_utils.cu:416-442);
    default path /tmp/<name>_latencies.txt (bench_base.cu:120-127)."""
    if not filename:
        filename = f"/tmp/{result.benchmark_name}_latencies.txt"
    s = result.statistics
    with open(filename, "w") as f:
        f.write("# Latency Statistics (ms)\n")
        f.write(f"# Count: {s.count}\n")
        f.write(f"# Mean: {s.mean:.3f}\n")
        f.write(f"# Median: {s.median:.3f}\n")
        f.write(f"# Std Dev: {s.std_dev:.3f}\n")
        f.write(f"# Min: {s.min_val:.3f}\n")
        f.write(f"# Max: {s.max_val:.3f}\n")
        f.write(f"# P95: {s.p95:.3f}\n")
        f.write(f"# P99: {s.p99:.3f}\n")
        f.write("#\n# Raw latencies:\n")
        for v in result.latencies:
            f.write(f"{v:.6f}\n")


def print_results(result: BenchmarkResult, cfg: BenchConfig) -> None:
    """Human-readable summary (globals.cu:26-67 + bench_base.cu:129-150)."""
    s = result.statistics
    print(f"\n=== {result.benchmark_name} ===")
    print(f"Min: {s.min_val:.3f} Max: {s.max_val:.3f} Avg: {s.mean:.3f}")
    svec = sorted(result.latencies)
    print(
        f"p50: {csv_percentile(svec, 0.50):.3f} "
        f"p95: {csv_percentile(svec, 0.95):.3f} "
        f"p99: {csv_percentile(svec, 0.99):.3f}"
    )
    threshold = cfg.deadline_ms()
    print(f"Latency threshold ({cfg.fs}Hz): {threshold:.3f} ms")
    p50, p95, p99 = (
        csv_percentile(svec, 0.50),
        csv_percentile(svec, 0.95),
        csv_percentile(svec, 0.99),
    )
    if p50 > threshold:
        print("WARNING: p50 exceeds threshold")
    elif p95 > threshold:
        print("WARNING: p95 exceeds threshold")
    elif p99 > threshold:
        print("WARNING: p99 exceeds threshold")
    else:
        print("OK: Measured latencies within threshold. Please consider a margin of safety.")

    from gpuaudiobench_jax.harness.statistics import stability_rating

    cv, rating = stability_rating(result.latencies)
    print(f"Run-to-run CV: {cv:.1f}% ({rating})")

    if result.device_statistics is not None:
        d = result.device_statistics
        method = f" [{result.device_timing_method}]" if result.device_timing_method else ""
        print(f"Device Median:  {d.median:.4f} ms{method}")
        print(f"Device P95:     {d.p95:.4f} ms")
        print(f"Device Mean:    {d.mean:.4f} ms")

    if result.saturated_statistics is not None:
        ss = result.saturated_statistics
        svec_sat = sorted(result.saturated_latencies)
        sat_p50 = csv_percentile(svec_sat, 0.50)
        sat_p95 = csv_percentile(svec_sat, 0.95)
        sat_p99 = csv_percentile(svec_sat, 0.99)
        verdict = "meets" if sat_p99 <= threshold else "MISSES"
        from gpuaudiobench_jax.harness.statistics import stability_rating

        sat_cv, sat_rating = stability_rating(result.saturated_latencies)
        _, marg_p50, bps, bps_basis = _saturated_derived(result)
        print(
            f"Saturated amortized (depth {result.pipeline_depth}): "
            f"p50 {sat_p50:.3f} p95 {sat_p95:.3f} p99 {sat_p99:.3f} "
            f"ms/block (wall/depth; includes sync floor/depth), "
            f"min {ss.min_val:.3f}, CV {sat_cv:.1f}% "
            f"({sat_rating}) ({verdict} deadline on p99)"
        )
        if marg_p50 is not None:
            print(
                f"Saturated marginal (depth "
                f"{result.saturated_lo_depth}->{result.pipeline_depth}): "
                f"p50 {marg_p50:.4f} ms/block (rig floor cancelled), "
                f"{bps:.1f} blocks/s [{bps_basis}]"
            )
        else:
            print(f"{bps:.1f} blocks/s [{bps_basis}]")

    if result.overlap_statistics is not None:
        os_, ov = result.overlap_serial_statistics, result.overlap_statistics
        sp = os_.median / ov.median if ov.median > 0 else 0.0
        print(
            f"Overlapped infeed (depth {result.overlap_depth}): "
            f"p50 {ov.median:.3f} ms/block vs serial {os_.median:.3f} "
            f"({sp:.2f}x; upload double-buffered against compute)"
        )

    print("\nPerformance Metrics:")
    print(f"Throughput:        {result.throughput_gbps:.3f} GB/s")
    print(f"Samples/sec:       {result.samples_per_sec:.0f}")
    print(f"Bytes processed:   {result.bytes_processed}")

    rl = result.metadata.get("roofline") if result.metadata else None
    if rl:
        flops_pct = rl.get("flops_pct_of_peak")
        flops_part = (
            f"{rl['achieved_gflops']:.1f} GFLOP/s"
            + (f" ({flops_pct:.1f}% of {rl['unit']} peak)" if flops_pct is not None else "")
        )
        bound = rl["bound"]
        if bound == "latency" and "nearest_wall" in rl:
            bound = (
                f"latency-bound (unsaturated; nearest wall "
                f"{rl['nearest_wall']} at {rl['nearest_wall_pct']:.1f}%)"
            )
        else:
            bound = f"{bound}-bound"
        print(
            f"Roofline [{rl['basis']}]: {flops_part}, "
            f"{rl['achieved_gbps']:.1f} GB/s HBM ({rl['hbm_pct_of_peak']:.1f}% "
            f"of peak) -> {bound} [{rl['peak_source']}]"
        )

    if result.deadline_miss_rate is not None:
        print(f"Deadline miss rate: {result.deadline_miss_rate:.1f}%")

    v = result.validation
    if v is not None:
        if v.status == ValidationStatus.SKIPPED:
            print("Validation skipped")
        elif v.passed:
            print(
                f"Validation passed (max_error={v.max_error:.3g}, "
                f"mean_error={v.mean_error:.3g}, checked={v.samples_checked})"
            )
        else:
            print(f"Validation FAILED for {result.benchmark_name}:")
            for msg in v.messages[:12]:
                print(f"  {msg}")
