"""DAWSessionMix: the composite session graph (EQ cascades -> reverb
send bus -> stereo mixdown) and its full-replay golden.

The golden (models/session.py session_reference) is first proven
against a by-definition brute force (np.convolve reverb on the
explicitly simulated bus stream); the device path is then validated
against the golden across iterations, replay-clamp boundaries,
streaming, and dp sharding.
"""

import numpy as np
import pytest

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.models.iir import iir_reference
from gpuaudiobench_jax.models.session import (
    WET_GAIN,
    DAWSessionMixBenchmark,
    session_mix_params,
    session_reference,
)
from gpuaudiobench_jax.utils.data import (
    biquad_lowpass_coefficients,
    reverb_impulse_responses,
)


def brute_force_session(x, stage_coeffs, send, pan2, ir, wet, k):
    """Block k of the session stream by definition: explicit per-block
    EQ state evolution, the full bus stream kept, np.convolve reverb."""
    t, b = x.shape
    n_stages = len(stage_coeffs)
    state = [np.zeros((t, 2), np.float32) for _ in range(n_stages)]
    bus_stream = []
    y = x
    for _ in range(k):
        y = x
        for s in range(n_stages):
            y, state[s] = iir_reference(y, stage_coeffs[s], state[s])
        bus_stream.append(send.astype(np.float64) @ y.astype(np.float64))
    bus = np.concatenate(bus_stream)
    rev = np.stack([
        np.convolve(bus, ir[c].astype(np.float64))[(k - 1) * b: k * b]
        for c in range(ir.shape[0])
    ])
    dry = pan2.astype(np.float64) @ y.astype(np.float64)
    return (dry + wet * rev).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_reference_matches_bruteforce(k):
    rng = np.random.default_rng(3)
    t, b, ir_len = 3, 16, 50
    x = (rng.standard_normal((t, b)) * 0.5).astype(np.float32)
    coeffs = [biquad_lowpass_coefficients(0.25 - 0.05 * s) for s in range(2)]
    send, pan2 = session_mix_params(t, seed=9)
    ir = reverb_impulse_responses(2, ir_len, 9)
    ref = session_reference(x, coeffs, send, pan2, ir, WET_GAIN, k)
    brute = brute_force_session(x, coeffs, send, pan2, ir, WET_GAIN, k)
    np.testing.assert_allclose(ref, brute, rtol=0, atol=1e-6)


def test_replay_clamp_is_steady_state():
    """Past the clamp the stream is periodic: the clamped golden must
    equal the full replay at k well beyond it (the validate() contract
    for long runs/soaks)."""
    rng = np.random.default_rng(5)
    t, b = 4, 64
    x = (rng.standard_normal((t, b)) * 0.5).astype(np.float32)
    coeffs = [biquad_lowpass_coefficients(0.25 - 0.0125 * s)
              for s in range(4)]
    send, pan2 = session_mix_params(t, seed=11)
    ir = reverb_impulse_responses(2, 256, 11)  # P = 4 partitions
    # models/session.py clamp at B=64: P + ceil(1024/64) + 8 = 28.
    clamp = 4 + 16 + 8
    full = session_reference(x, coeffs, send, pan2, ir, WET_GAIN, clamp + 13)
    clamped = session_reference(
        x, coeffs, send, pan2, ir, WET_GAIN, clamp + 13, clamp=clamp)
    np.testing.assert_allclose(full, clamped, rtol=0, atol=1e-6)


def _bench(**over):
    cfg = BenchConfig(n_runs=2, warmup=1, write_latencies=False,
                      quiet=True, device_timing=False, **over)
    b = DAWSessionMixBenchmark(cfg)
    b.setup()
    return b


@pytest.mark.parametrize("impl", ["xla"])
def test_device_matches_golden_over_iterations(impl):
    b = _bench(n_tracks=8, buffer_size=64, ir_length=300)
    for _ in range(5):  # + setup's iterate = 6 blocks, past P = 5
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert v.max_error < 1e-5  # far inside the 1e-3 contract


def test_output_shape_and_metadata():
    b = _bench(n_tracks=8, buffer_size=64, ir_length=300,
               session_eq_stages=6)
    assert b.host_output.shape == (2, 64)
    md = b.metadata()
    assert md["eqStages"] == 6
    assert md["partitions"] == 5
    assert b.cost_model()["flops"] > 0


def test_streaming_matches_iterate_evolution():
    """stream_body's carry after n steps == the benchmark's own state
    after n iterate() calls (same core, same input block)."""
    import jax

    b = _bench(n_tracks=8, buffer_size=64, ir_length=300)
    step, carry = b.stream_body()
    for _ in range(3):
        carry, _probe = step(carry)
    # Fresh instance: 3 total invocations (setup's + 2 more).
    b2 = _bench(n_tracks=8, buffer_size=64, ir_length=300)
    for _ in range(2):
        b2.iterate()
    _x, _send, _pan, eq, prev, fre, fim, _h = carry
    np.testing.assert_allclose(np.asarray(eq), np.asarray(b2._eq),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fre), np.asarray(b2._fre),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(prev), np.asarray(b2._prev),
                               rtol=0, atol=1e-6)
    del jax, fim


def test_data_parallel_equivalence():
    b1 = _bench(n_tracks=8, buffer_size=64, ir_length=300)
    b1.iterate()
    bdp = _bench(n_tracks=8, buffer_size=64, ir_length=300,
                 data_parallel=4)
    bdp.iterate()
    np.testing.assert_allclose(bdp.host_output, b1.host_output,
                               rtol=0, atol=1e-5)
    v = bdp.validate()
    assert v.passed, v.messages


def test_config_bounds():
    with pytest.raises(ValueError):
        BenchConfig(session_eq_stages=0).validate()
    with pytest.raises(ValueError):
        BenchConfig(session_eq_stages=17).validate()


def test_registered_and_ui_schema():
    from gpuaudiobench_jax.registry import (
        CATEGORIES,
        BENCHMARK_DESCRIPTIONS,
        list_benchmarks,
    )
    from gpuaudiobench_jax.webui.params import apply_params, benchmark_params

    assert "DAWSessionMix" in list_benchmarks()
    assert "DAWSessionMix" in CATEGORIES["session"]
    assert "DAWSessionMix" in BENCHMARK_DESCRIPTIONS
    schema = benchmark_params("DAWSessionMix")
    ids = {p["id"] for p in schema}
    assert {"sessionEqStages", "irLength"} <= ids
    cfg = apply_params(BenchConfig(), {"sessionEqStages": 8})
    assert cfg.session_eq_stages == 8


def test_dp_session_matches_golden():
    """Under --dataParallel the bus sum becomes a psum across the mesh;
    the stream still matches the golden block for block."""
    bdp = _bench(n_tracks=8, buffer_size=64, ir_length=300,
                 data_parallel=4)
    for _ in range(2):
        bdp.iterate()
    v = bdp.validate()
    assert v.passed, v.messages
    assert "ici_model" not in bdp.metadata()
