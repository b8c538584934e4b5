"""Derive the CUDA-schema CSV artifact from the suite JSON artifact.

One measurement, two serializations: run the suite once with --json,
then derive the CSV from that JSON, so the two can never disagree.
Columns reproduce harness/output.py's CSV writer: the
globals.cu:69-122 schema plus the saturated extension columns and the
device the row ran on.

Usage: python tools/json_to_csv.py RESULTS.json RESULTS.csv
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gpuaudiobench_jax.harness.output import (  # noqa: E402
    csv_from_json_results,
)


def convert(results: list) -> str:
    return csv_from_json_results(results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("json_path")
    ap.add_argument("csv_path")
    args = ap.parse_args(argv)
    results = json.load(open(args.json_path))
    if isinstance(results, dict):
        results = [results]
    with open(args.csv_path, "w") as f:
        f.write(convert(results))
    print(f"wrote {args.csv_path} ({len(results)} rows) from {args.json_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
