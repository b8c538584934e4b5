"""NeuralAmp: streaming dilated-TCN inference (the matrix-unit workload).

The float64 streaming twin is first proven against a by-definition
whole-stream dilated convolution (no tails, zero left padding); the
steady-state clamp the golden relies on is property-tested; then the
device path is validated against the golden across iterations, dtypes,
sharding, and the runner/streaming integration.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuaudiobench_jax.config import BenchConfig
from gpuaudiobench_jax.models.neuralamp import NeuralAmpBenchmark
from gpuaudiobench_jax.ops import neuralamp as na


def whole_stream_tcn(x: np.ndarray, k: int, params, layers: int):
    """Output block k of the repeated-block stream by the DEFINITION of
    dilated causal convolution: unroll the whole k-block stream, zero
    left padding, no carried tails."""
    stream = np.tile(x.astype(np.float64), (1, k))  # (T, k*B)
    h = np.tanh(
        stream[..., None] * params["w_in"].astype(np.float64)
        + params["b_in"].astype(np.float64))
    for l in range(layers):
        d = 1 << l
        ctx = (na.KERNEL - 1) * d
        padded = np.concatenate(
            [np.zeros((h.shape[0], ctx, h.shape[2])), h], axis=1)
        acc = np.broadcast_to(
            params[f"b{l}"].astype(np.float64), h.shape).copy()
        w = params[f"w{l}"].astype(np.float64)
        for j in range(na.KERNEL):
            acc += padded[:, j * d:j * d + h.shape[1]] @ w[j]
        h = h + np.tanh(acc)
    y = h @ params["w_out"].astype(np.float64) + float(params["b_out"])
    b = x.shape[1]
    return y[:, (k - 1) * b:k * b].astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3, 6])
@pytest.mark.parametrize("layers", [1, 3, 5])
def test_streaming_twin_matches_definition(k, layers):
    t, b, c = 2, 16, 8
    params = na.init_params(3, c, layers)
    x = np.random.default_rng(5).uniform(-1, 1, (t, b)).astype(np.float32)
    tails = tuple(
        np.zeros((t, ctx, c), np.float64)
        for ctx in na.context_lengths(layers))
    y = None
    for _ in range(k):
        y, tails = na.tcn_block_f64(x, tails, params, layers)
    np.testing.assert_allclose(
        y.astype(np.float32), whole_stream_tcn(x, k, params, layers),
        rtol=0, atol=1e-6)


def test_steady_state_clamp_is_exact():
    """tcn_reference clamps its replay at steady_blocks(); prove the
    output really is exactly periodic from that block on, and NOT
    before (so the clamp is tight, not accidental)."""
    t, b, c, layers = 2, 32, 8, 5
    params = na.init_params(9, c, layers)
    x = np.random.default_rng(2).uniform(-1, 1, (t, b)).astype(np.float32)
    ks = na.steady_blocks(layers, b)
    outs = []
    tails = tuple(
        np.zeros((t, ctx, c), np.float64)
        for ctx in na.context_lengths(layers))
    for _ in range(ks + 2):
        y, tails = na.tcn_block_f64(x, tails, params, layers)
        outs.append(y)
    assert np.array_equal(outs[ks - 1], outs[ks])
    assert np.array_equal(outs[ks], outs[ks + 1])
    assert not np.array_equal(outs[ks - 2], outs[ks - 1])
    # and tcn_reference returns exactly the clamped replay
    np.testing.assert_array_equal(
        na.tcn_reference(x, ks + 7, params, layers),
        outs[ks - 1].astype(np.float32))


def _bench(**over):
    kw = dict(n_runs=2, warmup=1, write_latencies=False,
              quiet=True, device_timing=False, n_tracks=4,
              buffer_size=64, neuralamp_channels=16,
              neuralamp_layers=4)
    kw.update(over)
    b = NeuralAmpBenchmark(BenchConfig(**kw))
    b.setup()
    return b


def test_device_matches_golden_over_iterations():
    b = _bench()
    for _ in range(5):  # setup ran one; spans past steady state
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert v.max_error < 1e-5  # f32 path: far inside the 1e-4 contract


def test_bf16_within_its_contract():
    b = _bench(neuralamp_dtype="bf16")
    for _ in range(4):
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert 1e-5 < v.max_error < 2e-2  # really bf16, really in contract


def test_int8_within_its_contract():
    """Dynamic per-tensor activation + per-output-channel weight int8:
    in the 5e-2 PTQ contract, and really quantized (error far above the
    bf16 mode's)."""
    b = _bench(neuralamp_dtype="int8")
    for _ in range(4):
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert 1e-4 < v.max_error < 5e-2
    assert b.cost_model()["unit"] == "int8"
    # Activation storage (the traffic that matters) matches the bf16
    # mode -- the integer path only changes GEMM operands and shrinks
    # the (small) weight read.
    bf16_cost = _bench(neuralamp_dtype="bf16").cost_model()
    d_weights = (na.param_bytes(16, 4, "bf16")
                 - na.param_bytes(16, 4, "int8"))
    assert b.cost_model()["hbm_bytes"] == bf16_cost["hbm_bytes"] - d_weights


def test_int8_weights_are_int8():
    """cast_params really emits int8 tap stacks + per-output-channel
    scales, and the quantization round-trips within 1 LSB."""
    import jax.numpy as jnp

    params = na.init_params(42, 16, 3)
    cp = na.cast_params(params, "int8")
    for l in range(3):
        assert cp[f"w{l}"].dtype == jnp.int8
        s = np.asarray(cp[f"w{l}_s"])
        back = np.asarray(cp[f"w{l}"], np.float32) * s
        assert np.abs(back - params[f"w{l}"]).max() <= (s.max() * 0.5 + 1e-9)
    assert cp["w_out"].dtype == jnp.float32


def test_int8_rejected_for_lstm():
    with pytest.raises(ValueError, match="int8 is TCN-only"):
        NeuralAmpBenchmark(
            BenchConfig(n_tracks=4, buffer_size=32, neuralamp_channels=8,
                        neuralamp_dtype="int8"),
            arch="lstm",
        ).setup()


def test_streaming_body_equals_iterate_stream():
    """stream_body's step must be the same program as iterate():
    stepping the carry k times reproduces the f64 reference block k."""
    b = _bench()
    step, carry = b.stream_body()
    # Above _STREAM_CONST_BYTES the carry rides (input, params, state)
    # so the weights stay runtime operands (not embedded constants) and
    # must come back unchanged so XLA can alias them; below it the
    # weights are deliberate closure constants (the LSTM scan measured
    # +70% saturated as runtime operands) but the INPUT still rides the
    # carry (it scales with tracks x buffer): (input, state).
    params_bytes = sum(int(v.nbytes) for v in b._params.values())
    carried_form = params_bytes > b._STREAM_CONST_BYTES
    assert carry[0] is b._resident_input
    if carried_form:
        assert carry[1] is b._params
    for _ in range(4):
        carry, _ = step(carry)
    state = carry[2] if carried_form else carry[1]
    y, _ = na.tcn_block(
        b._resident_input, state, b._params,
        layers=b.layers, dtype=b.dtype)
    ref = na.tcn_reference(b.host_input, 5, b.params_np, b.layers)
    peak = np.abs(ref).max()
    assert np.abs(np.asarray(y) - ref).max() / peak < 1e-4


def test_data_parallel_matches_single_device():
    single = _bench(n_tracks=8)
    for _ in range(2):
        single.iterate()
    sharded = _bench(n_tracks=8, data_parallel=8)
    for _ in range(2):
        sharded.iterate()
    np.testing.assert_allclose(
        single.host_output, sharded.host_output, rtol=0, atol=1e-6)
    assert sharded.validate().passed


def test_config_validation():
    with pytest.raises(ValueError, match="NeuralAmp dtype"):
        BenchConfig(neuralamp_dtype="f16").validate()
    with pytest.raises(ValueError, match="neuralamp_layers"):
        BenchConfig(neuralamp_layers=13).validate()
    with pytest.raises(ValueError, match="neuralamp_channels"):
        BenchConfig(neuralamp_channels=0).validate()


def test_cost_model_and_metadata():
    b = _bench()
    cost = b.cost_model()
    t, s, c, l = 4, 64, 16, 4
    assert cost["unit"] == "fp32"
    assert cost["flops"] == t * s * (4 * c + 2 * 3 * c * c * l)
    assert cost["hbm_bytes"] > (2 * l + 2) * t * s * c * 4
    assert _bench(neuralamp_dtype="bf16").cost_model()["unit"] == "bf16"
    md = b.metadata()
    assert md["receptiveField"] == na.receptive_field(4) == 31
    assert md["steadyBlocks"] == 2  # ctx 30 <= B 64 -> steady at block 2
    np.testing.assert_array_equal(
        na.tcn_reference(b.host_input, 2, b.params_np, 4),
        na.tcn_reference(b.host_input, 5, b.params_np, 4))


def test_params_deterministic_and_bf16_precast():
    p1 = na.init_params(42, 8, 3)
    p2 = na.init_params(42, 8, 3)
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k])
    cast = na.cast_params(p1, "bf16")
    assert cast["w0"].dtype == jnp.bfloat16  # tap matrices pre-cast
    assert cast["w_in"].dtype == jnp.float32  # input conv stays f32
    assert na.param_bytes(8, 3, "bf16") < na.param_bytes(8, 3, "f32")
    # bf16 mode is fully bf16-resident: tails are born bf16 and the
    # block keeps them bf16 (halves the carried-state HBM traffic).
    tails = na.init_tails(2, 8, 3, "bf16")
    assert all(t.dtype == jnp.bfloat16 for t in tails)
    b = _bench(neuralamp_dtype="bf16")
    assert all(t.dtype == jnp.bfloat16 for t in b._state)
    f32_cost = _bench().cost_model()["hbm_bytes"]
    assert b.cost_model()["hbm_bytes"] < f32_cost


# --- NeuralAmpLSTM (the recurrent architecture) -------------------------


def _lstm_bench(**over):
    kw = dict(n_runs=2, warmup=1, write_latencies=False,
              quiet=True, device_timing=False, n_tracks=4,
              buffer_size=64, neuralamp_channels=16)
    kw.update(over)
    b = NeuralAmpBenchmark(BenchConfig(**kw), arch="lstm")
    b.setup()
    return b


def test_lstm_orbit_convergence_bound():
    """lstm_steady_blocks is backed by a measured bound: by the clamp
    block the repeated-block f64 orbit moves < 1e-12/block (8 orders
    below the 1e-4 contract), and it has NOT converged at the start --
    and the bound holds across block sizes because the clamp counts
    SAMPLES of gate contraction, not blocks."""
    for b in (64, 256):
        t, hidden = 2, 16
        params = na.init_lstm_params(7, hidden)
        x = np.random.default_rng(3).uniform(
            -1, 1, (t, b)).astype(np.float32)
        h = np.zeros((t, hidden))
        c = np.zeros((t, hidden))
        ks = na.lstm_steady_blocks(b)
        assert (ks - 1) * b >= na.LSTM_STEADY_SAMPLES
        outs = []
        for _ in range(ks + 2):
            y, h, c = na.lstm_block_f64(x, h, c, params)
            outs.append(y)
        assert np.abs(outs[ks] - outs[ks - 1]).max() < 1e-12
        assert np.abs(outs[ks + 1] - outs[ks]).max() < 1e-12
        assert np.abs(outs[1] - outs[0]).max() > 1e-8  # not trivial
        np.testing.assert_array_equal(
            na.lstm_reference(x, ks + 9, params),
            outs[ks - 1].astype(np.float32))


def test_lstm_jit_matches_f64_twin():
    t, b, hidden = 2, 48, 16
    params = na.init_lstm_params(11, hidden)
    cp = na.cast_lstm_params(params, "f32")
    x = np.random.default_rng(4).uniform(-1, 1, (t, b)).astype(np.float32)
    h = jnp.zeros((t, hidden))
    c = jnp.zeros((t, hidden))
    h64 = np.zeros((t, hidden))
    c64 = np.zeros((t, hidden))
    for _ in range(3):
        y, h, c = na.lstm_block(jnp.asarray(x), h, c, cp, dtype="f32")
        y64, h64, c64 = na.lstm_block_f64(x, h64, c64, params)
    peak = np.abs(y64).max()
    assert np.abs(np.asarray(y) - y64).max() / peak < 1e-6
    # carried state agrees too (the stream is only as good as its state)
    assert np.abs(np.asarray(h) - h64).max() < 1e-6
    assert np.abs(np.asarray(c) - c64).max() < 1e-6


def test_lstm_device_matches_golden_over_iterations():
    b = _lstm_bench()
    for _ in range(6):
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert v.max_error < 1e-5


def test_lstm_bf16_within_contract():
    b = _lstm_bench(neuralamp_dtype="bf16")
    for _ in range(4):
        b.iterate()
    v = b.validate()
    assert v.passed, v.messages
    assert 1e-8 < v.max_error < 1e-3


def test_lstm_registry_and_metadata():
    from gpuaudiobench_jax.registry import create_benchmark

    b = create_benchmark(
        "NeuralAmpLSTM",
        BenchConfig(n_tracks=4, buffer_size=32, neuralamp_channels=8,
                    write_latencies=False, device_timing=False, quiet=True))
    b.setup()
    assert b.name == "NeuralAmpLSTM"
    md = b.metadata()
    assert md["arch"] == "lstm"
    assert md["steadyBlocks"] == na.lstm_steady_blocks(32)
    cost = b.cost_model()
    assert cost["flops"] == 4 * 32 * (2 * 9 * 32 + 16)
    # recurrent workload: HBM story is x/y + state, far below TCN's
    assert cost["hbm_bytes"] < 100_000


def test_lstm_data_parallel_matches_single_device():
    single = _lstm_bench(n_tracks=8)
    for _ in range(2):
        single.iterate()
    sharded = _lstm_bench(n_tracks=8, data_parallel=8)
    for _ in range(2):
        sharded.iterate()
    np.testing.assert_allclose(
        single.host_output, sharded.host_output, rtol=0, atol=1e-6)
    assert sharded.validate().passed


def test_tensor_parallel_matches_single_device():
    """Channel-sharded (Megatron column-parallel) block == tcn_block,
    including the carried tails across two streamed blocks."""
    import jax
    from jax.sharding import Mesh

    from gpuaudiobench_jax.parallel.neuralamp_sharded import (
        make_neuralamp_tp_block,
    )

    t, b, c, layers = 2, 32, 16, 4
    params = na.init_params(42, c, layers)
    cp = na.cast_params(params, "f32")
    x = jnp.asarray(
        np.random.default_rng(1).uniform(-1, 1, (t, b)).astype(np.float32))
    tails = tuple(jnp.asarray(a) for a in na.init_tails(t, c, layers))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("tp",))
    fn = make_neuralamp_tp_block(mesh, layers)
    y1, t1 = na.tcn_block(x, tails, cp, layers=layers, dtype="f32")
    y2, t2 = fn(x, tails, cp)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=0, atol=1e-6)
    y1b, _ = na.tcn_block(x, t1, cp, layers=layers, dtype="f32")
    y2b, _ = fn(x, t2, cp)
    np.testing.assert_allclose(np.asarray(y1b), np.asarray(y2b),
                               rtol=0, atol=1e-6)


def test_lstm_tensor_parallel_matches_single_device():
    """Hidden-sharded LSTM block == lstm_block, including the carried
    (h, c) across two streamed blocks."""
    import jax
    from jax.sharding import Mesh

    from gpuaudiobench_jax.parallel.neuralamp_sharded import (
        make_neuralamp_lstm_tp_block,
    )

    t, b, hidden = 2, 32, 16
    params = na.init_lstm_params(42, hidden)
    cp = na.cast_lstm_params(params, "f32")
    x = jnp.asarray(
        np.random.default_rng(1).uniform(-1, 1, (t, b)).astype(np.float32))
    h0 = jnp.zeros((t, hidden), jnp.float32)
    c0 = jnp.zeros((t, hidden), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("tp",))
    fn = make_neuralamp_lstm_tp_block(mesh)
    y1, h1, c1 = na.lstm_block(x, h0, c0, cp, dtype="f32")
    y2, h2, c2 = fn(x, h0, c0, cp)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=0, atol=1e-6)
    y1b, _, _ = na.lstm_block(x, h1, c1, cp, dtype="f32")
    y2b, _, _ = fn(x, h2, c2, cp)
    np.testing.assert_allclose(np.asarray(y1b), np.asarray(y2b),
                               rtol=0, atol=1e-6)


def test_f32_mode_contracts_in_float32():
    """The f32 mode's GEMMs run at HIGHEST: on the GPU a DEFAULT or HIGH
    float32 product may run in TF32, which measured 5.5e-4 of peak on
    NeuralAmp (H100), past the 1e-4 contract."""
    assert na.F32_GEMM_PRECISION == "highest"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["NeuralAmp", "NeuralAmpLSTM"])
def test_f32_contract_holds_on_the_card(gpu_device, small_cfg, name):
    from gpuaudiobench_jax.registry import create_benchmark

    b = create_benchmark(name, small_cfg)
    b.setup()
    b.iterate()
    v = b.validate()
    assert v.passed, v.messages[:3]


def test_runner_integration(small_cfg):
    from gpuaudiobench_jax.harness.runner import run_benchmark
    from gpuaudiobench_jax.registry import create_benchmark

    cfg = small_cfg.replace(neuralamp_channels=16, neuralamp_layers=3,
                            pipeline_depth=4)
    bench = create_benchmark("NeuralAmp", cfg)
    bench.setup()
    r = run_benchmark(bench, cfg)
    assert r.validation.passed
    assert r.saturated_statistics is not None
    assert r.metadata["dtype"] == "f32"


def test_stream_params_form_thresholded():
    """Weights embed as closure constants below _STREAM_CONST_BYTES
    (the LSTM scan measured +70% saturated with params as runtime
    operands) and ride the carry above it (the module-size class).
    The default LSTM (H=128, ~0.5 MB) must take the closure form."""
    import jax

    small = NeuralAmpBenchmark(
        BenchConfig(n_runs=1, warmup=1, verification="none", quiet=True,
                    write_latencies=False, device_timing=False,
                    n_tracks=2, buffer_size=64, neuralamp_channels=128),
        arch="lstm")
    small.setup()
    _, carry = small.stream_body()
    # (input, state) carry: params dict embedded, but the input block
    # still rides the carry (it scales with tracks x buffer).
    assert isinstance(carry, tuple) and len(carry) == 2
    assert carry[0] is small._resident_input
    assert not any(isinstance(c, dict) for c in carry)
    assert all(isinstance(c, jax.Array)
               for c in jax.tree_util.tree_leaves(carry))

    big = NeuralAmpBenchmark(
        BenchConfig(n_runs=1, warmup=1, verification="none", quiet=True,
                    write_latencies=False, device_timing=False,
                    n_tracks=2, buffer_size=64, neuralamp_channels=512),
        arch="lstm")
    big.setup()
    _, carry = big.stream_body()
    assert carry[0] is big._resident_input and carry[1] is big._params
