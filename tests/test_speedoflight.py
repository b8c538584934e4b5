"""speedoflight category: the microbenchmarks that say what the card
reaches beside its published peaks (models/speedoflight.py,
ops/speedoflight.py)."""

import numpy as np
import pytest

from gpuaudiobench_jax.harness.runner import run_benchmark
from gpuaudiobench_jax.registry import CATEGORIES, create_benchmark

SOL_NAMES = ["SOL_FMA_f32", "SOL_HBM", "SOL_MMA_bf16", "SOL_MMA_tf32",
             "SOL_MMA_int8"]


def test_speedoflight_category_registered():
    assert CATEGORIES["speedoflight"] == SOL_NAMES


@pytest.mark.parametrize("k", [16, 64, 600])
def test_fma_chain_closed_form(rng, k):
    """The FMA chain must match its closed form exactly enough that the
    benchmark's validation is a real check (k f32 roundings), both
    fully unrolled and through the fori_loop past _FULL_UNROLL."""
    from gpuaudiobench_jax.ops.speedoflight import fma_chain, fma_golden

    x = (rng.random((16, 1024), dtype=np.float32) * 2 - 1).astype(np.float32)
    y = np.asarray(fma_chain(x, k))
    np.testing.assert_allclose(y, fma_golden(x, k), atol=5e-4)


@pytest.mark.parametrize("name", SOL_NAMES)
def test_sol_benchmark_validates(small_cfg, name):
    bench = create_benchmark(name, small_cfg)
    bench.setup()
    result = run_benchmark(bench, small_cfg, verbose=False)
    assert result.validation.passed, result.validation.messages[:3]
    cost = bench.cost_model()
    assert cost["flops"] > 0 and cost["hbm_bytes"] > 0


@pytest.mark.parametrize("name,unit", [
    ("SOL_FMA_f32", "fp32"), ("SOL_HBM", "fp32"), ("SOL_MMA_bf16", "bf16"),
    ("SOL_MMA_tf32", "tf32"), ("SOL_MMA_int8", "int8"),
])
def test_sol_units_name_the_card_unit(small_cfg, name, unit):
    """Each microbenchmark is judged against the peak of the unit it
    exercises."""
    bench = create_benchmark(name, small_cfg)
    bench.setup()
    assert bench.cost_model()["unit"] == unit


def test_sol_rejects_data_parallel(small_cfg):
    cfg = small_cfg.replace(data_parallel=2)
    bench = create_benchmark("SOL_FMA_f32", cfg)
    with pytest.raises(ValueError, match="single-device"):
        bench.setup()


def test_matmul_tf32_tolerance_catches_bf16(rng):
    """The TF32 check (4 * 2^-10 of the largest output) passes a
    TF32-class result and fails one whose operands were rounded to bf16
    (8-bit mantissa), the error a wrong precision would make."""
    import jax.numpy as jnp

    d = 256
    a = rng.standard_normal((d, d)).astype(np.float32)
    b = rng.standard_normal((d, d)).astype(np.float32)
    golden = a.astype(np.float64) @ b.astype(np.float64)
    peak = np.abs(golden).max()

    def rounded(x, bits):
        m, e = np.frexp(x)
        return np.ldexp(np.round(m * 2.0 ** bits) / 2.0 ** bits, e)

    tol = 4 * 2.0 ** -10
    tf32 = rounded(a, 11) @ rounded(b, 11)
    bf16 = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64) @ np.asarray(
        jnp.asarray(b, jnp.bfloat16), np.float64)
    assert np.abs(tf32 - golden).max() / peak < tol
    assert np.abs(bf16 - golden).max() / peak > tol / 4


def test_matmul_bf16_tolerance_catches_a_bf16_output(rng):
    """The bf16 check (2^-16 of the largest output, against a float64
    golden) passes f32 accumulation of the exact bf16 products in
    tensor-core-sized chunks and fails an output rounded to bf16."""
    import jax.numpy as jnp

    d = 512
    a = np.asarray(jnp.asarray(rng.uniform(-1, 1, (d, d)), jnp.bfloat16),
                   np.float64)
    b = np.asarray(jnp.asarray(rng.uniform(-1, 1, (d, d)), jnp.bfloat16),
                   np.float64)
    golden = a @ b
    peak = np.abs(golden).max()
    acc = np.zeros((d, d), np.float32)
    for k in range(0, d, 16):
        acc += (a[:, k:k + 16] @ b[k:k + 16]).astype(np.float32)
    rounded = np.asarray(jnp.asarray(golden.astype(np.float32),
                                     jnp.bfloat16), np.float64)
    tol = 2.0 ** -16
    assert np.abs(acc - golden).max() / peak < tol / 10
    assert np.abs(rounded - golden).max() / peak > 10 * tol


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_matmul_golden_is_float64(small_cfg, dtype):
    bench = create_benchmark(f"SOL_MMA_{dtype}", small_cfg)
    bench.setup()
    assert bench.golden.dtype == np.float64
    assert bench.validate().passed


def test_int8_golden_is_exact_through_float64(small_cfg):
    """The int8 golden runs through float64 BLAS (an int64 matmul takes
    minutes at the default size); every value is an integer below 2^53,
    so it equals the integer product."""
    bench = create_benchmark("SOL_MMA_int8", small_cfg)
    bench.setup()
    exact = bench.host_a.astype(np.int64) @ bench.host_b.astype(np.int64)
    np.testing.assert_array_equal(bench.golden, exact.astype(np.float64))
