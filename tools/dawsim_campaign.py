"""DAW-sim measurement campaign: the poster's tab7/tab8 analog.

Measures how DAW-style buffer pacing (spin vs sleep between iterations)
perturbs round-trip latency, for the modal bank and a transfer
benchmark: p50/p95/max per mode plus the p50 runtime multiplier
(paced / unpaced), like figs/tab7.png and tab8.png.

Every workload runs at the poster's 512-sample buffer (10.667 ms
period): a pacer only waits -- the regime tab7/tab8 measures -- while
the round trip fits inside the period, which a card in the same host
as the pacer allows.

Usage: python tools/dawsim_campaign.py [output.md]
"""

from __future__ import annotations

import _pathfix  # noqa: F401,E402 - repo-root sys.path (tools/_pathfix.py)

import sys

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import create_benchmark

MODES = ["off", "sleep", "spin"]

WORKLOADS = [
    # (label, benchmark, cfg overrides)
    ("Modal 1M modes (buf 512)", "ModalFilterBank",
     dict(n_tracks=1024, buffer_size=512)),
    ("datacopy5050 1 MiB (buf 512)", "datacopy5050",
     dict(transfer_mib=1, buffer_size=512)),
    # The DAW workload itself under DAW pacing.
    ("DAWSessionMix 128 strips (buf 512)", "DAWSessionMix",
     dict(buffer_size=512)),
]


def run_one(name: str, overrides: dict, mode: str):
    cfg = BenchConfig(
        n_runs=30, warmup=3, write_latencies=False, device_timing=False,
        verification="spot",
        dawsim=(mode != "off"),
        dawsim_mode=(mode if mode != "off" else "spin"),
        **overrides,
    )
    bench = create_benchmark(name, cfg)
    bench.setup()
    result = run_benchmark(bench, cfg, verbose=False)
    s = result.statistics
    return {
        "p50": s.median, "p95": s.p95, "max": s.max_val,
        "miss": result.deadline_miss_rate,
        "deadline": cfg.deadline_ms(),
        "ok": result.validation is None or result.validation.passed,
    }


def main() -> int:
    from gpuaudiobench_jax.utils import device as dev

    out_path = sys.argv[1] if len(sys.argv) > 1 else "dawsim.md"
    lines = [
        f"# DAW-sim pacing campaign ({dev.default_device().device_kind}; "
        f"{dev.card_info() or 'no nvidia-smi'})",
        "",
        "tab7/tab8 analog: p50/p95/max round-trip latency with the DAW",
        "pacer off / sleep / spin, plus the p50 multiplier vs unpaced.",
        "",
        "| Workload | pacer | p50 ms | p95 ms | max ms | p50 mult | miss rate |",
        "|---|---|---:|---:|---:|---:|---:|",
    ]
    for label, name, overrides in WORKLOADS:
        base_p50 = None
        for mode in MODES:
            r = run_one(name, overrides, mode)
            if not r["ok"]:
                print(f"{label} [{mode}]: VALIDATION FAILED")
                return 1
            if mode == "off":
                base_p50 = r["p50"]
            mult = r["p50"] / base_p50 if base_p50 else float("nan")
            miss = f"{r['miss']:.0f}%" if r["miss"] is not None else "-"
            lines.append(
                f"| {label} | {mode} | {r['p50']:.2f} | {r['p95']:.2f} | "
                f"{r['max']:.2f} | x{mult:.3f} | {miss} |"
            )
            print(lines[-1])
    lines += [
        "",
        f"Deadlines: {', '.join(f'{w[0]}: {BenchConfig(**w[2]).deadline_ms():.1f} ms' for w in WORKLOADS)}.",
        "Reference (tab8): PC p50 multipliers x1.05-x2.74, AS x1.11-x2.86",
        "depending on workload; pacing hurts most when the workload is",
        "dispatch-bound, least when transfer-bound.",
    ]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"written: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
