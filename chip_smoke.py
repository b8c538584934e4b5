"""Smoke test of the suite on one GPU, through the entry points a user calls.

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --four-cards  # four cards: the multi-device path only
    python chip_smoke.py --rehearse    # toy sizes; runs on the CPU when
                                       # JAX_PLATFORMS=cpu (tests use this)

Phases, one process for the whole run (a JAX process reserves most of
the card's memory, so no second JAX process is started):

1. device: the default device must be a GPU; its kind and count, and
   the card's name and power limit from nvidia-smi.
2. compile cache: the directory in use.
3. headline: ``bench.run()`` at its full defaults (1,048,576 modes onto
   32 tracks, 512-sample blocks, pipeline depth 512); its record must
   pass validation.
4. modal kernel: the Triton kernel against ``modal_bank_xla`` and the
   NumPy golden at 1,048,576 x 32 x 512, both saturated per-block
   times interleaved in this process, and the kernel step's
   ``compiled.memory_analysis()``.
5. suite: every registered benchmark outside the multichip category
   through ``run_benchmark`` at its default sizes, each against its
   golden, with its device time from the profiler trace.
6. speed of light: what a large bf16 product and a large copy reach,
   beside the card's published peaks.
7. gpu tests: the tests marked ``gpu`` (``pytest -m gpu``), run in this
   process on the card.
8. (--four-cards) MultiChipSuite on a 4-device mesh with tp = 4 and
   with sp = 4, each against its golden and the same step on one
   device, plus ``__graft_entry__.dryrun_multichip(4)``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase ends the run with a non-zero exit and no such line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

MODES, TRACKS, SAMPLES = 1 << 20, 32, 512
MODAL_TOLERANCE = 1e-4  # ModalFilterBank's peak-relative tolerance


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def toy_config():
    from gpuaudiobench_jax.config import BenchConfig

    return BenchConfig(buffer_size=64, n_tracks=8, n_runs=3, warmup=1,
                       rndmem_pool_mb=8, write_latencies=False,
                       verification="spot", sol_fma_k=16, sol_fma_mib=1,
                       sol_stream_mib=1, sol_matmul_dim=128)


def phase_device(rehearse: bool, want: int):
    import jax

    from gpuaudiobench_jax.utils import device as dev

    d = jax.devices()
    if d[0].platform != "gpu" and not (rehearse and d[0].platform == "cpu"):
        raise SystemExit(f"no GPU: JAX's default device is {d[0].platform!r}")
    if len(d) < want:
        raise SystemExit(f"{want} devices needed, {len(d)} found")
    say("device", f"platform={d[0].platform} kind={d[0].device_kind!r} "
        f"count={len(d)}")
    card = dev.card_info()  # nvidia-smi's name, power.limit line(s)
    print(card if card else "[device] nvidia-smi: not available",
          flush=True)
    return dev.device_record()


def phase_headline(rehearse: bool):
    import bench

    rec = (bench.run(n_tracks=2, n_runs=3, warmup=1, pipeline_depth=8)
           if rehearse else bench.run())
    say("headline", json.dumps(rec))
    if rec["validation"] != "passed":
        raise RuntimeError(f"headline validation failed: {rec}")


def _interleaved_saturated(steps, carry, depth: int, reps: int):
    """Per-block ms of each chained step, timed in turns (A, B, A, B...)
    so drift over the window falls on both."""
    import jax
    import numpy as np

    def chained(step):
        @jax.jit
        def run(c):
            return jax.lax.scan(lambda c, _: step(c), c, None,
                                length=depth)[1]
        return run

    runs = [chained(s) for s in steps]
    for r in runs:
        np.asarray(r(carry))  # compile + warm
    times = [[] for _ in runs]
    for _ in range(reps):
        for r, t in zip(runs, times):
            t0 = time.perf_counter()
            np.asarray(r(carry))
            t.append((time.perf_counter() - t0) / depth * 1e3)
    return [median(t) for t in times]


def phase_modal(rehearse: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuaudiobench_jax.models.modal import modal_reference
    from gpuaudiobench_jax.ops.modal import modal_bank_xla
    from gpuaudiobench_jax.ops.modal_triton import modal_step

    m, t, s = (4096, 32, 64) if rehearse else (MODES, TRACKS, SAMPLES)
    g = np.random.Generator(np.random.MT19937(42))
    amp = g.random(m, dtype=np.float32)
    w = (np.float32(2 * np.pi) * g.random(m, dtype=np.float32)
         * np.float32(0.45)).astype(np.float32)
    cos_w, sin_w = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = g.random(m, dtype=np.float32) * 2 - 1
    im = g.random(m, dtype=np.float32) * 2 - 1
    golden = modal_reference(amp, cos_w, sin_w, re, im, s, t)
    peak = float(np.abs(golden).max())

    cd, sd = jnp.asarray(cos_w), jnp.asarray(sin_w)
    re_f, im_f = jnp.asarray(amp * re), jnp.asarray(amp * im)

    def kernel(c):
        out, r2, i2 = modal_step(cd, sd, c[0], c[1], s, t,
                                 interpret=rehearse)
        return (r2, i2), out[:, 0]

    def xla(c):
        out, r2, i2 = modal_bank_xla(None, cd, sd, c[0], c[1], s, t)
        return (r2, i2), out[:, 0]

    out_k, re_k, _ = modal_step(cd, sd, re_f, im_f, s, t,
                                interpret=rehearse)
    out_x, re_x, _ = modal_bank_xla(None, cd, sd, re_f, im_f, s, t)
    err_k = float(np.abs(np.asarray(out_k) - golden).max()) / peak
    err_x = float(np.abs(np.asarray(out_x) - golden).max()) / peak
    err_state = float(np.abs(np.asarray(re_k) - np.asarray(re_x)).max())
    say("modal", f"{m} modes x {t} tracks x {s} samples: max error / "
        f"golden peak: triton {err_k:.3e}, xla {err_x:.3e} (tolerance "
        f"{MODAL_TOLERANCE:g}); state vs xla {err_state:.3e}")
    if not err_k <= MODAL_TOLERANCE or not err_x <= MODAL_TOLERANCE:
        raise RuntimeError("modal kernel outside the tolerance")

    compiled = jax.jit(
        lambda a, b, c, d: modal_step(a, b, c, d, s, t, interpret=rehearse)
    ).lower(cd, sd, re_f, im_f).compile()
    say("modal", f"kernel step memory_analysis: {compiled.memory_analysis()}")

    depth, reps = (4, 3) if rehearse else (64, 15)
    ms_k, ms_x = _interleaved_saturated([kernel, xla], (re_f, im_f),
                                        depth, reps)
    say("modal", f"saturated per-block ms (depth {depth}, median of "
        f"{reps}, interleaved): triton {ms_k:.4f}, xla {ms_x:.4f} "
        f"(xla/triton {ms_x / ms_k:.2f}x)")


def phase_suite(rehearse: bool):
    import jax

    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.registry import CATEGORIES, create_benchmark

    base = (toy_config() if rehearse else
            BenchConfig(n_runs=5, warmup=1, verification="spot",
                        write_latencies=False))
    names = [n for cat, ns in CATEGORIES.items() if cat != "multichip"
             for n in ns]
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            b = create_benchmark(name, base)
            b.setup()
            r = run_benchmark(b, base, verbose=False)
            v = r.validation
            dev_ms = (f"{r.device_statistics.median:.4f}"
                      if r.device_statistics else "not measured")
            say("suite", f"{name}: {'passed' if v.passed else 'FAILED'} "
                f"max_error={v.max_error:.3e} tolerance={b.tolerance:g} "
                f"roundtrip_p50_ms={r.statistics.median:.4f} "
                f"device_ms={dev_ms} "
                f"({time.perf_counter() - t0:.1f} s)")
            if not v.passed:
                failed.append(name)
                say("suite", f"{name}: {v.messages[:3]}")
            b.cleanup()
            del b
        except Exception as e:  # noqa: BLE001 - report every benchmark
            failed.append(name)
            say("suite", f"{name}: ERROR {type(e).__name__}: {e}")
            traceback.print_exc()
        jax.clear_caches()
    if failed:
        raise RuntimeError(f"benchmarks failed: {failed}")


def phase_speed_of_light(rehearse: bool):
    import jax
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops.speedoflight import matmul_bf16, stream_scale
    from gpuaudiobench_jax.utils import device as dev
    from gpuaudiobench_jax.utils.roofline import PEAKS

    d, n = (256, 1 << 16) if rehearse else (8192, 1 << 28)
    a = jnp.ones((d, d), jnp.bfloat16)
    x = jnp.ones((n,), jnp.float32)

    def best(fn, *args, reps=10):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return median(ts)

    tflops = 2 * d ** 3 / best(matmul_bf16, a, a) / 1e12
    tbps = 2 * n * 4 / best(stream_scale, x) / 1e12
    peaks = PEAKS.get(dev.default_device().device_kind)
    if peaks is None:
        say("sol", f"bf16 {d}^3 matmul {tflops:.2f} TFLOP/s, copy of "
            f"{n * 4 >> 20} MiB {tbps:.3f} TB/s; no published peaks for "
            f"{dev.default_device().device_kind!r}")
        return
    say("sol", f"bf16 {d}^3 matmul {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / peaks['bf16']:.1f}% of {peaks['bf16'] / 1e12:g}"
        f"; read+write of {n * 4 >> 20} MiB {tbps:.3f} TB/s = "
        f"{100 * tbps * 1e12 / peaks['hbm_bytes_per_sec']:.1f}% of "
        f"{peaks['hbm_bytes_per_sec'] / 1e12:g} ({peaks['source']}; "
        f"card: {dev.card_info()})")


def phase_gpu_tests(rehearse: bool):
    import os

    import pytest

    if rehearse:  # on the CPU every gpu test would skip
        say("tests", "skipped in a rehearsal")
        return

    os.environ["AUDIOBENCH_GPU_TESTS"] = "1"  # tests/conftest.py: no CPU
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests")])
    say("tests", f"pytest -m gpu exit code {int(rc)}")
    if rc != 0:
        raise RuntimeError(f"gpu tests failed (pytest exit code {int(rc)})")


def phase_four_cards(rehearse: bool):
    """MultiChipSuite on a 4-device mesh, with the modal psum (tp = 4)
    and with the FIR halo ppermute (sp = 4), each against its golden
    and against the same step on one device; then the dry run of every
    sharded block."""
    import jax
    import numpy as np

    import __graft_entry__
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.parallel.multichip import single_device_step
    from gpuaudiobench_jax.registry import create_benchmark

    base = (toy_config() if rehearse else BenchConfig(
        n_runs=5, warmup=1, verification="full", write_latencies=False))
    one = jax.devices()[0]
    for mesh in ("1,4,1", "1,1,4"):
        cfg = base.replace(mesh=mesh)
        b = create_benchmark("MultiChipSuite", cfg)
        b.setup()
        r = run_benchmark(b, cfg, verbose=False)
        devices = {d.id for a in b._args for d in a.sharding.device_set}
        out_devs = {d.id for d in b._step(*b._args).sharding.device_set}
        ref = np.asarray(single_device_step(
            *(jax.device_put(a, one) for a in b._args)))
        err = (float(np.abs(b.host_output - ref).max())
               / float(np.abs(ref).max()))
        say("4cards", f"MultiChipSuite mesh {mesh}: "
            f"{'passed' if r.validation.passed else 'FAILED'} "
            f"max_error={r.validation.max_error:.3e} vs golden; max diff / "
            f"peak vs one device {err:.3e}; inputs on devices "
            f"{sorted(devices)}, output on {sorted(out_devs)}; "
            f"roundtrip_p50_ms={r.statistics.median:.4f}")
        if not r.validation.passed:
            raise RuntimeError(f"MultiChipSuite {mesh} failed validation")
        if not err <= 1e-4:
            raise RuntimeError(f"mesh {mesh} differs from one device")
        if len(out_devs) != 4:
            raise RuntimeError(f"mesh {mesh} ran on devices {out_devs}")
    __graft_entry__.dryrun_multichip(4)
    say("4cards", "dryrun_multichip(4): finite outputs on 4 devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device path and its comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes; allows the CPU (JAX_PLATFORMS=cpu)")
    args = ap.parse_args(argv)
    try:
        from gpuaudiobench_jax.utils import device as dev
    except ImportError as e:
        print(f"chip_smoke: the suite is not importable here: {e}",
              file=sys.stderr)
        return 2
    cache = dev.enable_compilation_cache()
    record = phase_device(args.rehearse, 4 if args.four_cards else 1)
    say("cache", f"compile cache directory: {cache}")

    phases = ([("4cards", phase_four_cards)] if args.four_cards else [
        ("headline", phase_headline),
        ("modal", phase_modal),
        ("suite", phase_suite),
        ("sol", phase_speed_of_light),
        ("tests", phase_gpu_tests),
    ])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(args.rehearse)
            say(name, f"done in {time.perf_counter() - t0:.1f} s")
        except Exception as e:  # noqa: BLE001 - every phase reports
            failed.append(name)
            traceback.print_exc()
            say(name, f"FAILED: {type(e).__name__}: {e}")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
