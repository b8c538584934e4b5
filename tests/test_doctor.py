"""tools/doctor.py: environment triage must stay hang-proof and honest."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "doctor.py"), *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )


def test_doctor_healthy_on_cpu_backend():
    r = _run("--probe-timeout", "120")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[+] device" in r.stdout          # probe answered
    assert "doctor: healthy" in r.stdout
    # The CPU has no published peaks: a warning, not a failure.
    assert "[x]" not in r.stdout


def test_doctor_reports_wedged_device_without_hanging():
    # A probe timeout small enough that even a healthy CPU backend
    # cannot answer exercises the wedged path: FAIL row, rc 1, and the
    # doctor itself returns promptly (the probe runs in a subprocess).
    r = _run("--probe-timeout", "0.05")
    assert r.returncode == 1
    assert "[x] device" in r.stdout
    assert "NOT healthy" in r.stdout
    assert "wedged" in r.stdout
