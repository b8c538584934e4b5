"""Compare suite results against the reference's published numbers.

The reference repo ships an empty analysis/ stub; this implements the
comparison the DAFx-24 poster tables invite: read a CSV produced by the
harness (`--outputfile`) or a JSON results file and print each
benchmark's latency next to the published RTX 4070 ("PC") and M2 Pro
("AS") numbers from BASELINE.md, where they exist.

Usage:
  python -m gpuaudiobench_jax.cli --benchmarkFilter /.*/ \
      --outputfile results.csv
  python analysis/compare.py results.csv
"""

from __future__ import annotations

import csv
import json
import sys

# Published p50/p95 (ms) from BASELINE.md (DAFx-24 poster tab4/tab5/tab6).
PUBLISHED = {
    # benchmark: {platform: (p50, p95)}
    "ModalFilterBank": {"PC": (3.168, 3.941), "AS": (5.717, 5.87)},  # 1M modes
    "datacopy0199": {"PC": (10.06, 11.82), "AS": (9.14, 9.25)},  # 100 MiB scale
    "datacopy2080": {"PC": (9.84, 11.68), "AS": (8.77, 8.85)},
    "datacopy5050": {"PC": (9.57, 11.5), "AS": (8.49, 8.56)},
    "datacopy8020": {"PC": (9.37, 11.1), "AS": (7.93, 8.01)},
    "datacopy9901": {"PC": (9.09, 10.59), "AS": (7.66, 7.75)},
    "RndMemRead": {"PC": (0.163, 0.427), "AS": (0.657, 0.787)},  # 128 trk
    "NoOp": {"PC": (0.015, None), "AS": (0.125, None)},  # fig4 bulk
}

# Modal mode-count sweep (poster tab4): published p50/p95 per platform.
MODAL_SWEEP = {
    # modes: {"PC": (p50, p95), "AS": (p50, p95)}
    1024:    {"PC": (0.050, 0.183), "AS": (0.172, 0.203)},
    102400:  {"PC": (0.315, 0.447), "AS": (0.611, 0.671)},
    1048576: {"PC": (3.168, 3.941), "AS": (5.717, 5.870)},
}


def print_modal_sweep() -> None:
    print("Modal mode-count sweep (tab4, published p50 ms):")
    print(f"{'modes':>9} {'PC p50':>8} {'AS p50':>8}")
    for modes, row in MODAL_SWEEP.items():
        print(f"{modes:>9} {row['PC'][0]:>8.3f} {row['AS'][0]:>8.3f}")
    print()


NOTES = {
    "ModalFilterBank": "published = 1M modes (run with --nTracks 1024)",
    "datacopy0199": "published = 100 MiB pool (harness default 10 MiB)",
    "datacopy2080": "published = 100 MiB pool",
    "datacopy5050": "published = 100 MiB pool",
    "datacopy8020": "published = 100 MiB pool",
    "datacopy9901": "published = 100 MiB pool",
    "RndMemRead": "published = 128 MiB pool, 128 tracks",
    "NoOp": "published = histogram bulk p50 (fig4)",
}


def load_rows(path: str):
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = [data]
        for r in data:
            yield {
                "benchmark": r["benchmark"],
                "p50_ms": r["statistics"]["p50_ms"],
                "p95_ms": r["statistics"]["p95_ms"],
                "p99_ms": r["statistics"]["p99_ms"],
                "threshold_ms": r["deadline"]["threshold_ms"],
                "meets_deadline": r["deadline"]["meets_deadline"],
            }
        return
    with open(path) as f:
        for row in csv.DictReader(f):
            yield {
                "benchmark": row["benchmark"],
                "p50_ms": float(row["p50_ms"]),
                "p95_ms": float(row["p95_ms"]),
                "p99_ms": float(row["p99_ms"]),
                "threshold_ms": float(row["threshold_ms"]),
                "meets_deadline": row["meets_deadline"] == "true",
            }


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    rows = list(load_rows(argv[0]))
    print_modal_sweep()
    print(f"{'benchmark':<16} {'p50':>9} {'p95':>9} {'deadline':>9} "
          f"{'PC p50':>8} {'vs PC':>7}  note")
    print("-" * 86)
    for r in rows:
        name = r["benchmark"]
        pub = PUBLISHED.get(name, {})
        pc = pub.get("PC", (None, None))[0]
        speedup = f"{pc / r['p50_ms']:.2f}x" if pc else "-"
        ok = "ok " if r["meets_deadline"] else "MISS"
        print(
            f"{name:<16} {r['p50_ms']:>9.3f} {r['p95_ms']:>9.3f} "
            f"{ok:>5}{r['threshold_ms']:>5.1f} "
            f"{pc if pc else '-':>8} {speedup:>7}  {NOTES.get(name, '')}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
