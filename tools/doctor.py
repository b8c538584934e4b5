"""Environment health check: is this rig ready to produce trustworthy
numbers, and if not, which part is broken?

Every check is something that has actually bitten a measurement
session (docs/OPERATIONS.md); the device probe runs in a SUBPROCESS
with a timeout because a wedged device plugin can hang a process at
first device use -- including, without this indirection, the doctor
itself.

Usage: python tools/doctor.py [--probe-timeout SECONDS]
Exit code: 0 = all checks passed or only warnings; 1 = a failure.
"""

from __future__ import annotations

import os
import sys

# tests load this file via importlib from the repo root, where tools/
# is not on sys.path; make _pathfix resolvable from any load style.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _pathfix  # noqa: F401,E402 - repo-root sys.path (tools/_pathfix.py)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

OK, WARN, FAIL = "ok", "warn", "FAIL"


def _report(rows, code):
    width = max(len(r[1]) for r in rows)
    for status, name, detail in rows:
        mark = {"ok": "+", "warn": "!", "FAIL": "x"}[status]
        print(f" [{mark}] {name.ljust(width)}  {detail}")
    print("doctor:", "healthy" if code == 0 else "NOT healthy")
    return code


def probe_device(timeout_s: float):
    """(status, detail, kind): import jax and list devices in a child
    process so a wedged device plugin cannot hang the doctor."""
    code = (
        "import json, jax; d = jax.devices(); "
        "print(json.dumps({'platform': d[0].platform, "
        "'kind': d[0].device_kind, 'n': len(d)}))"
    )
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return (FAIL,
                f"no answer in {timeout_s:.0f}s -- device wedged, or "
                "another process holds it mid-suite (see "
                "docs/OPERATIONS.md 'Hung / wedged device')", None)
    if r.returncode != 0:
        return (FAIL, (r.stderr.strip().splitlines() or ["no backend"])[-1],
                None)
    try:
        info = json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return (FAIL, f"unparseable probe output: {r.stdout[:120]!r}", None)
    return (OK, f"{info['n']}x {info['kind']} [{info['platform']}]",
            info["kind"])


def check_peaks(device_kind):
    from gpuaudiobench_jax.utils.roofline import PEAKS

    if device_kind is None:
        return (WARN, "device unreachable; cannot look up its peaks")
    if device_kind in PEAKS:
        return (OK, PEAKS[device_kind]["source"])
    return (WARN, f"no published peaks for {device_kind!r} -- rooflines "
            "are not computed (a GPU needs a utils/roofline.py entry)")


def check_compile_cache():
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")  # utils/device.py REPO_CACHE_DIR
    if not os.path.isdir(d):
        return (WARN, f"{d} absent -- first runs pay full XLA compiles "
                "(created automatically on first cached run)")
    n = sum(len(fs) for _, _, fs in os.walk(d))
    return (OK, f"{d} ({n} entries)")


def check_native():
    binpath = os.path.join(os.path.dirname(__file__), "..", "native",
                           "build", "gpubench")
    if not os.path.exists(binpath):
        return (WARN, "native/build/gpubench not built (make -C native); "
                "Python CLI unaffected")
    return (OK, os.path.normpath(binpath))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe-timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    rows = []
    status, detail, kind = probe_device(args.probe_timeout)
    rows.append((status, "device", detail))
    s, d = check_peaks(kind)
    rows.append((s, "roofline peaks", d))
    s, d = check_compile_cache()
    rows.append((s, "compile cache", d))
    s, d = check_native()
    rows.append((s, "native driver", d))
    code = 1 if any(r[0] == FAIL for r in rows) else 0
    return _report(rows, code)


if __name__ == "__main__":
    raise SystemExit(main())
