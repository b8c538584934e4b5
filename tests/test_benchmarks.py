"""End-to-end benchmark tests: every registered benchmark runs on the
scaled-down config and passes its own golden-case validation -- the
hardware-free CI mode the reference lacks (SURVEY.md s4)."""

import numpy as np
import pytest

from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import BENCHMARK_NAMES, create_benchmark

FAST_NAMES = [n for n in BENCHMARK_NAMES if n != "FDTD3D"]


@pytest.mark.parametrize("name", FAST_NAMES)
def test_benchmark_validates(small_cfg, name):
    bench = create_benchmark(name, small_cfg)
    bench.setup()
    result = run_benchmark(bench, small_cfg, verbose=False)
    assert result.validation is not None
    assert result.validation.passed, (
        f"{name}: {result.validation.messages[:3]}"
    )
    assert len(result.latencies) == small_cfg.n_runs
    assert result.statistics.count == small_cfg.n_runs
    assert result.statistics.mean > 0


@pytest.mark.slow
def test_fdtd3d_validates(small_cfg):
    cfg = small_cfg.replace(buffer_size=32)
    bench = create_benchmark("FDTD3D", cfg)
    bench.setup()
    result = run_benchmark(bench, cfg, verbose=False)
    assert result.validation.passed, result.validation.messages[:3]


def test_registry_has_17_names():
    assert len(BENCHMARK_NAMES) == 17


def test_gain_golden_values(small_cfg):
    bench = create_benchmark("gain", small_cfg)
    bench.setup()
    bench.iterate()
    np.testing.assert_allclose(
        bench.host_output, 2.0 * bench.host_input, atol=1e-6
    )


def test_iir_repeated_iterations_stay_valid(small_cfg):
    # State persists on-device across iterations (reference semantics,
    # models/iir.py); the golden carries state once per performed
    # iteration, so validation holds for any iteration count.
    cfg = small_cfg.replace(buffer_size=512)
    bench = create_benchmark("IIRFilter", cfg)
    bench.setup()
    for _ in range(5):
        bench.iterate()
    v = bench.validate()
    assert v.passed, v.messages[:3]


def test_rndmem_playheads_advance(small_cfg):
    bench = create_benchmark("RndMemRead", small_cfg)
    bench.setup()
    ph0 = bench.playheads.copy()
    bench.iterate()
    ph1 = bench.playheads
    assert not np.array_equal(ph0, ph1)
    # each advanced by bufferSize or wrapped to its loop start
    advanced = ph1 == ph0 + small_cfg.buffer_size
    wrapped = ph1 == bench.playheads_start.astype(np.int32)
    assert np.all(advanced | wrapped)
    assert bench.validate().passed


def test_verification_modes(small_cfg):
    for mode in ("full", "spot", "none"):
        cfg = small_cfg.replace(verification=mode)
        bench = create_benchmark("gain", cfg)
        bench.setup()
        bench.iterate()
        v = bench.validate()
        assert v.passed
        if mode == "none":
            assert v.samples_checked == 0


def test_biquad_chain_extension(small_cfg):
    bench = create_benchmark("BiquadChain", small_cfg)
    bench.setup()
    result = run_benchmark(bench, small_cfg, verbose=False)
    assert result.validation.passed, result.validation.messages[:3]
    assert result.metadata["numStages"] == 10


def test_fdtd_per_track_receivers(small_cfg):
    """WebGPU parity: --fdtdPerTrackReceivers gives each track its own
    receiver cell on the x line at mid y/z (FDTD3DBenchmark.js:57-67)."""
    import numpy as np

    cfg = small_cfg.replace(buffer_size=16, n_tracks=4,
                            fdtd_per_track_receivers=True)
    bench = create_benchmark("FDTD3D", cfg)
    bench.setup()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    # tracks read different cells -> rows differ bitwise (in broadcast
    # mode all rows are the identical receiver trace)
    out = np.asarray(bench.host_output)
    assert len({row.tobytes() for row in out}) > 1
    assert bench.metadata()["receiver"] == "per-track line"


def test_fdtd_source_receiver_ghost_offset():
    """Round-2 parity fix: source/receiver carry the one-cell ghost
    offset (grid (26,26,6)/(41,16,26) in the 52^3 grid, matching
    bench_fdtd3d's indexing)."""
    from gpuaudiobench_jax.ops import fdtd3d as op

    assert op.SOURCE == (26, 26, 6)
    assert op.RECEIVER == (41, 16, 26)


def test_fdtd_room_positions_scale_and_match_reference():
    """--fdtdRoom scales source/receiver at the reference's room
    fractions; at room 50 they ARE the reference cells (26,26,6) /
    (41,16,26) (bench_fdtd3d.cu indexing + ghost offset)."""
    from gpuaudiobench_jax.ops import fdtd3d as op

    assert op.source_pos(50) == op.SOURCE
    assert op.receiver_pos(50) == op.RECEIVER
    assert op.grid_n(50) == op.GRID_N
    # smaller room: positions stay interior (never in the ghost ring)
    for room in (10, 16, 30, 100):
        n = op.grid_n(room)
        for c in op.source_pos(room) + op.receiver_pos(room):
            assert 1 <= c <= n - 2, (room, c)


def test_fdtd_room_configurable_validates(small_cfg):
    """A non-default room runs end-to-end against its own full CPU-sim
    golden (room 16: 18^3 grid)."""
    cfg = small_cfg.replace(buffer_size=16, n_tracks=2, fdtd_room=16)
    bench = create_benchmark("FDTD3D", cfg)
    bench.setup()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    md = bench.metadata()
    assert md["room"] == 16 and md["grid"] == [18, 18, 18]
    from gpuaudiobench_jax.ops import fdtd3d as op

    assert md["source"] == list(op.source_pos(16))
    # a different room gives a genuinely different acoustic path
    cfg2 = small_cfg.replace(buffer_size=16, n_tracks=2, fdtd_room=24)
    b2 = create_benchmark("FDTD3D", cfg2)
    b2.setup()
    assert b2.validate().passed
    assert not np.array_equal(bench.host_output, b2.host_output)


def test_fdtd_room_config_validation():
    from gpuaudiobench_jax.config import BenchConfig

    with pytest.raises(ValueError, match="fdtd_room"):
        BenchConfig(fdtd_room=4).validate()
    with pytest.raises(ValueError, match="fdtd_room"):
        BenchConfig(fdtd_room=200).validate()


def test_iir_blockstate_form_validates(small_cfg):
    """--iirForm blockstate runs the same contract end-to-end: carried
    state across iterations, output + state validation, streaming."""
    cfg = small_cfg.replace(buffer_size=512, iir_form="blockstate",
                            iir_block_m=16)
    bench = create_benchmark("IIRFilter", cfg)
    bench.setup()
    for _ in range(4):
        bench.iterate()
    v = bench.validate()
    assert v.passed, v.messages[:3]
    assert bench.metadata()["form"] == "blockstate"
    step, carry = bench.stream_body()
    carry, probe = step(carry)
    assert probe.shape == (1,)


def test_iir_blockstate_config_bounds():
    import pytest

    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.ops.iir import blockstate_effective_m

    with pytest.raises(ValueError, match="iir form"):
        BenchConfig(iir_form="fir").validate()
    with pytest.raises(ValueError, match="iir_block_m"):
        BenchConfig(iir_block_m=1).validate()
    with pytest.raises(ValueError, match="iir_block_m"):
        BenchConfig(iir_block_m=129).validate()
    BenchConfig(iir_form="blockstate", iir_block_m=0).validate()  # auto
    # m clamps to a divisor >= 2 when one exists...
    BenchConfig(iir_form="blockstate", buffer_size=100,
                iir_block_m=16).validate()
    assert blockstate_effective_m(100, 16) == 10
    assert blockstate_effective_m(512, 128) == 128
    assert blockstate_effective_m(64, 128) == 64
    # ...but a prime buffer has none in [2, 128]: both blockstate
    # forms degenerate at m = 1 (the carry is w's last TWO rows), so
    # config rejects it upfront and the op raises the same class.
    with pytest.raises(ValueError, match="divisor"):
        BenchConfig(iir_form="blockstate", buffer_size=509).validate()
    with pytest.raises(ValueError, match="divisor"):
        blockstate_effective_m(509, 128)
    # scan has no such constraint.
    BenchConfig(iir_form="scan", buffer_size=509).validate()
