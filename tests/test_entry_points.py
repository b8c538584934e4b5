"""Entry points: bench.py and chip_smoke.py refuse a machine without a
GPU, the compile cache follows its directory rules, and chip_smoke.py's
phases run end to end at toy size on the CPU (its ``--rehearse`` mode)."""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_root(name):
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_without_gpu(script):
    """No accelerator and no explicit JAX_PLATFORMS=cpu: a non-zero
    exit, and no result line."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stdout + r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_chip_smoke_refuses_cpu_without_rehearse():
    """JAX_PLATFORMS=cpu alone does not make the CPU a GPU."""
    smoke = _import_root("chip_smoke")
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main([])


@pytest.mark.parametrize("env,allowed", [
    ("cpu", True), (" cpu ", True), (None, False), ("cuda,cpu", False),
])
def test_require_gpu_on_the_cpu(monkeypatch, env, allowed):
    from gpuaudiobench_jax.utils import device as dev

    if env is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", env)
    if allowed:
        assert dev.require_gpu() == "cpu"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            dev.require_gpu()


def test_device_record_names_platform_kind_count():
    from gpuaudiobench_jax.utils import device as dev

    assert dev.device_record() == {"platform": "cpu", "kind": "cpu",
                                   "count": len(jax.devices())}
    assert dev.card_info() is None  # no nvidia-smi here


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself: nothing is set in
    code, and the directory in use is reported."""
    from gpuaudiobench_jax.utils import device as dev

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert dev.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    from gpuaudiobench_jax.utils import device as dev

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = dev.enable_compilation_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def _smoke(argv):
    smoke = _import_root("chip_smoke")
    before = jax.config.jax_compilation_cache_dir
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = smoke.main(argv)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return rc, buf.getvalue().splitlines()


def test_chip_smoke_rehearsal():
    """Every phase of the one-card run, at toy size on the CPU, ends in
    the contract's last line."""
    rc, lines = _smoke(["--rehearse"])
    assert rc == 0, lines[-5:]
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "cpu", "kind": "cpu",
                   "count": len(jax.devices())}}
    for phase in ("device", "cache", "headline", "modal", "suite", "sol"):
        assert any(ln.startswith(f"[{phase}]") for ln in lines), phase
    assert not any("FAILED" in ln for ln in lines)
    headline = next(ln for ln in lines if ln.startswith("[headline] {"))
    rec = json.loads(headline[len("[headline] "):])
    assert rec["validation"] == "passed" and rec["kernel"] == "xla"


def test_chip_smoke_four_card_rehearsal():
    """The four-card path (tp = 4 psum, sp = 4 halo) on four of the
    virtual CPU devices, each mesh against one device."""
    rc, lines = _smoke(["--four-cards", "--rehearse"])
    assert rc == 0, lines[-5:]
    assert json.loads(lines[-1])["ok"] is True
    meshes = [ln for ln in lines if "MultiChipSuite mesh" in ln]
    assert len(meshes) == 2
    for ln in meshes:
        assert "passed" in ln and "output on [0, 1, 2, 3]" in ln
    assert not any(ln.startswith("[headline]") for ln in lines)


def test_single_device_step_matches_the_sharded_step():
    from gpuaudiobench_jax.parallel import (
        make_mesh,
        make_suite_step,
        suite_step_example_args,
    )
    from gpuaudiobench_jax.parallel.multichip import single_device_step

    mesh = make_mesh(4, dp=1, tp=2, sp=2)
    args = suite_step_example_args(mesh)
    sharded = np.asarray(make_suite_step(mesh)(*args))
    one = jax.devices()[0]
    ref = np.asarray(single_device_step(
        *(jax.device_put(a, one) for a in args)))
    np.testing.assert_allclose(sharded, ref,
                               atol=1e-5 * np.abs(ref).max())
