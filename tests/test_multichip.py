"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuaudiobench_jax.parallel import (
    make_mesh,
    make_suite_step,
    suite_step_example_args,
)
from gpuaudiobench_jax.parallel.multichip import _biquad_block, _local_conv


def _sequential_reference(args, tp: int):
    """Single-device reference of the full pipeline (same math, no mesh)."""
    x, amp, cos_w, sin_w, s_re, s_im, ir, coeffs = (np.asarray(a) for a in args)
    t, s = x.shape
    y = np.asarray(_biquad_block(jnp.asarray(2.0 * x), jnp.asarray(coeffs[0])))
    l = ir.shape[0]
    pad = np.concatenate([np.zeros((t, l - 1), np.float32), y], axis=1)
    conv = np.asarray(_local_conv(jnp.asarray(pad), jnp.asarray(ir)))
    # modal mix
    re, im = s_re.copy(), s_im.copy()
    mix = np.zeros((32, s), np.float32)
    for n in range(s):
        re, im = re * cos_w - im * sin_w, re * sin_w + im * cos_w
        mix[:, n] = (amp * re).reshape(-1, 32).sum(axis=0)
    mixed = conv + mix[np.arange(t) % 32, :]
    out = mixed
    for k in range(tp):
        out = np.asarray(_biquad_block(jnp.asarray(out), jnp.asarray(coeffs[k])))
    return out


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def test_mesh_axes(mesh8):
    assert set(mesh8.shape.keys()) == {"dp", "tp", "sp"}
    assert np.prod(list(mesh8.shape.values())) == 8


def test_suite_step_runs_and_matches_reference(mesh8):
    fn = make_suite_step(mesh8)
    args = suite_step_example_args(mesh8)
    out = np.asarray(jax.block_until_ready(fn(*args)))
    assert np.isfinite(out).all()
    ref = _sequential_reference(args, tp=mesh8.shape["tp"])
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_suite_step_output_sharded(mesh8):
    fn = make_suite_step(mesh8)
    args = suite_step_example_args(mesh8)
    out = fn(*args)
    spec = out.sharding.spec
    assert tuple(spec) == ("dp", "sp")


def test_dryrun_entry():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
    fn, ex = ge.entry()
    y, state = jax.jit(fn)(*ex)
    assert np.isfinite(np.asarray(y)).all()


@pytest.mark.parametrize("name", ["gain", "IIRFilter", "Conv1D", "GainStats"])
def test_data_parallel_benchmarks(name):
    """--dataParallel shards the track axis over the device mesh; the
    jitted programs partition via XLA SPMD and still validate."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = BenchConfig(
        buffer_size=64, n_tracks=16, n_runs=2, warmup=1,
        write_latencies=False, device_timing=False, data_parallel=8,
    )
    bench = create_benchmark(name, cfg)
    bench.setup()
    bench.iterate()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    # resident input really is sharded over dp
    assert len(bench._resident_input.sharding.device_set) == 8


def test_data_parallel_requires_divisibility():
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = BenchConfig(buffer_size=64, n_tracks=9, n_runs=1, warmup=0,
                      data_parallel=8, write_latencies=False,
                      device_timing=False)
    bench = create_benchmark("gain", cfg)
    with pytest.raises(ValueError):
        bench.setup()


def test_fdtd_sharded_matches_single_device(mesh8):
    """Domain-decomposed FDTD (x-axis over the mesh, ppermute halo
    exchange) reproduces the single-device program."""
    from gpuaudiobench_jax.ops.fdtd3d import fdtd3d_block, zero_fields
    from gpuaudiobench_jax.parallel.fdtd_sharded import make_fdtd_sharded_block
    from gpuaudiobench_jax.utils.data import generate_random_audio

    x = generate_random_audio(4 * 16, 42).reshape(4, 16)
    ref, *_ = fdtd3d_block(jnp.asarray(x), *zero_fields())
    fn = make_fdtd_sharded_block(mesh8, axis="sp")
    out = fn(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("NoOp", {}),
    ("Conv1D_accel", {}),
    ("BiquadChain", {}),
    ("PartConv", {"ir_length": 256}),
    ("FFT1D", {}),
    ("ModalFilterBank", {}),
    ("DWG1DNaive", {}),
    ("DWG1DAccel", {}),
    ("RndMemRead", {"rndmem_pool_mb": 8}),
    ("datacopy5050", {"transfer_mib": 1}),
    ("datacopy2080", {"transfer_mib": 10}),
])
def test_data_parallel_full_coverage(name, kw):
    """Round 2: --dataParallel must never silently no-op. Every
    benchmark either shards its parallel axis (tracks / modes /
    waveguides / transfer pool) over the dp mesh, or fails fast."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = BenchConfig(
        buffer_size=64, n_tracks=16, n_runs=2, warmup=1,
        write_latencies=False, device_timing=False, data_parallel=8,
        **kw,
    )
    bench = create_benchmark(name, cfg)
    bench.setup()
    bench.iterate()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    assert bench._sharding is not None  # really sharded, not a no-op


def test_data_parallel_datacopy_divisibility():
    """Indivisible transfer portions fail fast with a clear error."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = BenchConfig(transfer_mib=1, data_parallel=8, n_runs=1, warmup=0,
                      write_latencies=False, device_timing=False)
    bench = create_benchmark("datacopy2080", cfg)
    with pytest.raises(ValueError, match="divisible by --dataParallel"):
        bench.setup()


def test_data_parallel_fdtd_fails_fast():
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = BenchConfig(
        buffer_size=64, n_tracks=8, n_runs=2, warmup=1,
        write_latencies=False, device_timing=False, data_parallel=8,
    )
    bench = create_benchmark("FDTD3D", cfg)
    with pytest.raises(ValueError, match="domain decomposition"):
        bench.setup()


def test_data_parallel_guard_in_runner():
    """A benchmark that never declares a sharded axis cannot run under
    --dataParallel."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.base import Benchmark
    from gpuaudiobench_jax.harness.runner import run_benchmark

    cfg = BenchConfig(n_runs=1, warmup=0, data_parallel=8,
                      write_latencies=False, device_timing=False)

    class Opaque(Benchmark):
        name = "opaque"

        def setup(self):
            pass

        def iterate(self):
            pass

    b = Opaque(cfg)
    b.setup()
    with pytest.raises(ValueError, match="does not support --dataParallel"):
        run_benchmark(b, cfg, verbose=False)


@pytest.mark.parametrize("mesh", ["1,1,1", "2,2,2", "8,1,1", "1,1,8"])
def test_multichip_suite_benchmark(mesh):
    """MultiChipSuite as a registered benchmark: the sharded pipeline
    validates against the 1x1x1-mesh reference on every mesh shape."""
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = BenchConfig(buffer_size=64, n_tracks=16, n_runs=2, warmup=1,
                      write_latencies=False, device_timing=False, mesh=mesh)
    b = create_benchmark("MultiChipSuite", cfg)
    b.setup()
    b.iterate()
    v = b.validate()
    assert v.passed, v.messages[:3]
    assert b.metadata()["mesh"] == dict(
        zip(("dp", "tp", "sp"), map(int, mesh.split(","))))


@pytest.mark.parametrize("mesh", ["1,1,1", "2,2,2", "8,1,1"])
def test_ici_bandwidth_benchmark(mesh):
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = BenchConfig(n_runs=2, warmup=1, transfer_mib=1,
                      write_latencies=False, device_timing=False, mesh=mesh)
    b = create_benchmark("LinkBandwidth", cfg)
    b.setup()
    b.iterate()
    v = b.validate()
    assert v.passed, v.messages[:3]


def test_mesh_too_large_fails_fast():
    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = BenchConfig(mesh="64,1,1", n_runs=1, warmup=0,
                      write_latencies=False, device_timing=False)
    b = create_benchmark("LinkBandwidth", cfg)
    with pytest.raises(ValueError, match="devices"):
        b.setup()


def test_mesh_parse_errors():
    from gpuaudiobench_jax.models.multichip_bench import parse_mesh

    assert parse_mesh("2,2,2") == (2, 2, 2)
    with pytest.raises(ValueError):
        parse_mesh("2,2")
    with pytest.raises(ValueError):
        parse_mesh("2,0,1")


def test_multichip_rejects_unfoldable_modes(small_cfg):
    from gpuaudiobench_jax.registry import create_benchmark

    b = create_benchmark(
        "MultiChipSuite", small_cfg.replace(modal_num_modes=1000)
    )
    with pytest.raises(ValueError, match="divisible by 32"):
        b.setup()


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 2), (1, 4, 1)])
def test_ici_inventory_matches_compiled_hlo(mesh8, shape):
    """The collectives one MultiChipSuite step needs are the ones XLA
    emits: compile the step on a virtual mesh and count all-gather /
    all-reduce / collective-permute ops in the optimized HLO.

    The step's inventory (parallel/multichip.py make_suite_step): over
    sp, the input and the mixed signal are all-gathered and the FIR halo
    is one ppermute; over tp, the modal mix and the output are psums and
    each of the 2 pipeline microbatches crosses tp-1 stage boundaries.
    XLA also emits degenerate collectives over singleton axes and can
    fold the microbatch hops into fewer static ops, so non-degenerate
    axes assert LOWER bounds, and the exact correspondence is pinned for
    the (1,2,2) mesh where it holds op-for-op (2 AG, 2 AR, 1 halo +
    (tp-1) = 3 CP)."""
    from gpuaudiobench_jax.models.multichip_bench import build_mesh
    from gpuaudiobench_jax.parallel.multichip import (
        make_suite_step,
        suite_step_example_args,
    )

    dp, tp, sp = shape
    if dp * tp * sp > len(jax.devices()):
        pytest.skip("needs more virtual devices")
    mesh = build_mesh(shape, ("dp", "tp", "sp"))
    args = suite_step_example_args(mesh, tracks=16, samples=256,
                                   modes=32 * tp * 8,
                                   ir_len=33, seed=42)
    hlo = jax.jit(make_suite_step(mesh)).lower(*args).compile().as_text()
    counts = {op: hlo.count(f" {op}(") + hlo.count(f" {op}-start(")
              for op in ("all-gather", "all-reduce", "collective-permute")}

    want_ag = 2 if sp > 1 else 0
    want_ar = 2 if tp > 1 else 0
    want_cp = (1 if sp > 1 else 0) + (tp - 1)
    assert counts["all-gather"] >= want_ag, counts
    assert counts["all-reduce"] >= want_ar, counts
    assert counts["collective-permute"] >= want_cp, counts
    if shape == (1, 2, 2):  # measured exact op-for-op correspondence
        assert counts == {"all-gather": 2, "all-reduce": 2,
                          "collective-permute": 3}, counts


def test_partconv_partition_sharded_matches_single_device():
    """Partition-sharded streaming convolution (ppermute spectrum
    handoff + psum of partial spectra) reproduces the single-device
    shift-form block across > P streamed blocks."""
    from gpuaudiobench_jax.ops.partconv import (
        num_partitions,
        partconv_block,
        partition_spectra,
    )
    from gpuaudiobench_jax.parallel.mesh import make_mesh
    from gpuaudiobench_jax.parallel.partconv_sharded import (
        make_partconv_sharded_block,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, dp=1, tp=8, sp=1)

    rng = np.random.default_rng(5)
    t, b, length = 2, 16, 128  # P = 8 partitions, one per rank
    p = num_partitions(length, b)
    ir = rng.standard_normal((t, length)).astype(np.float32)
    h_re, h_im = partition_spectra(jnp.asarray(ir), b)
    fn = make_partconv_sharded_block(mesh, p, axis="tp")

    zeros_fdl = jnp.zeros((t, p, b + 1), jnp.float32)
    prev_s = prev_m = jnp.zeros((t, b), jnp.float32)
    fs = (zeros_fdl, zeros_fdl)
    fm = (zeros_fdl, zeros_fdl)
    for k in range(p + 4):
        x = jnp.asarray(rng.standard_normal((t, b)).astype(np.float32))
        ys, *fs = partconv_block(x, prev_s, *fs, h_re, h_im)
        ym, *fm = fn(x, prev_m, *fm, h_re, h_im)
        prev_s = prev_m = x
        ys, ym = np.asarray(ys), np.asarray(ym)
        np.testing.assert_allclose(
            ym, ys, atol=1e-5 * max(np.abs(ys).max(), 1.0),
            err_msg=f"block {k}")


def test_partconv_sharded_rejects_indivisible_partitions():
    from gpuaudiobench_jax.parallel.mesh import make_mesh
    from gpuaudiobench_jax.parallel.partconv_sharded import (
        make_partconv_sharded_block,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, dp=1, tp=8, sp=1)
    with pytest.raises(ValueError, match="not divisible"):
        make_partconv_sharded_block(mesh, 9, axis="tp")
