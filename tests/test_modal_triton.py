"""The Triton modal kernel (ops/modal_triton.py): run through the Pallas
interpreter on the CPU against the XLA scan and the NumPy golden, its
tile and padding choices, its lowering for CUDA, and (``gpu`` tests) the
compiled kernel on the card."""

import numpy as np
import pytest

from gpuaudiobench_jax.models.modal import modal_reference
from gpuaudiobench_jax.ops.modal import modal_bank_xla
from gpuaudiobench_jax.ops.modal_triton import (
    TILE_GROUPS,
    modal_step,
    padded_shape,
    tile_groups,
)


def _bank(rng, m):
    amp = rng.random(m, dtype=np.float32)
    w = 2 * np.pi * rng.random(m, dtype=np.float32) * 0.45
    cw, sw = np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    return amp, cw, sw, re, im


SHAPES = [(4096, 32), (960, 32), (256, 8)]


@pytest.mark.parametrize("m,t_out", SHAPES)
def test_modal_triton_matches_xla(rng, m, t_out):
    """Output and rotated (amp-prefolded) state match the XLA scan, and
    the output matches the golden within the model's 1e-4 of peak."""
    s = 32
    amp, cw, sw, re, im = _bank(rng, m)
    ref, re_x, im_x = modal_bank_xla(amp, cw, sw, re, im, s, t_out)
    out, re_k, im_k = modal_step(cw, sw, amp * re, amp * im, s, t_out,
                                 interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(np.asarray(re_k), amp * np.asarray(re_x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(im_k), amp * np.asarray(im_x),
                               atol=1e-5)
    golden = modal_reference(amp, cw, sw, re, im, s, t_out)
    peak = np.abs(golden).max()
    assert np.abs(np.asarray(out) - golden).max() <= 1e-4 * peak


@pytest.mark.parametrize("blocks", [2, 3])
def test_modal_triton_state_continues_across_blocks(rng, blocks):
    """Chaining blocks through the returned state equals one long run."""
    m, t_out, s = 256, 32, 16
    amp, cw, sw, re, im = _bank(rng, m)
    ref, _, _ = modal_bank_xla(amp, cw, sw, re, im, blocks * s, t_out)
    ref = np.asarray(ref)
    r, i = amp * re, amp * im
    for k in range(blocks):
        out, r, i = modal_step(cw, sw, r, i, s, t_out, interpret=True)
        np.testing.assert_allclose(np.asarray(out),
                                   ref[:, k * s:(k + 1) * s], atol=1e-4)


@pytest.mark.parametrize("m,t_out,max_tile", [
    (3 * 7, 3, 4),      # tracks padded 3 -> 4, groups 7 -> 8
    (32 * 130, 32, 64),  # groups 130 -> 192: three programs
    (5 * 33, 5, 16),     # both axes padded, several programs
])
def test_modal_triton_padding(rng, m, t_out, max_tile):
    """Banks whose groups or tracks are not powers of two are padded
    with silent modes; output and state come back unpadded."""
    s = 24
    amp, cw, sw, re, im = _bank(rng, m)
    out, re_k, _ = modal_step(cw, sw, amp * re, amp * im, s, t_out,
                              max_tile=max_tile, interpret=True)
    assert np.asarray(out).shape == (t_out, s)
    assert np.asarray(re_k).shape == (m,)
    golden = modal_reference(amp, cw, sw, re, im, s, t_out)
    assert np.abs(np.asarray(out) - golden).max() <= 1e-4 * np.abs(
        golden).max()


@pytest.mark.parametrize("groups,expect", [
    (1, 1), (3, 4), (64, 64), (100, 128), (TILE_GROUPS, TILE_GROUPS),
    (32768, TILE_GROUPS),
])
def test_tile_groups(groups, expect):
    assert tile_groups(groups) == expect


def test_padded_shape_at_the_bench_shape():
    """1M modes onto 32 tracks: no padding, 256 programs of 128 groups
    (about two per SM of an H100)."""
    gp, tp, tile = padded_shape(1 << 20, 32)
    assert (gp, tp, tile) == (32768, 32, 128)
    assert gp // tile == 256


def test_padded_shape_rejects_ragged_bank():
    with pytest.raises(ValueError, match="multiple of output_tracks"):
        padded_shape(100, 32)


@pytest.mark.parametrize("m,t_out,s", [(1 << 20, 32, 512), (960, 32, 48),
                                       (256, 8, 100)])
def test_modal_triton_lowers_for_cuda(m, t_out, s):
    """The kernel lowers through Pallas' Triton rules for CUDA with no
    GPU present: the exported module holds one Triton call with the
    tile's grid and the requested warps."""
    import jax
    import jax.numpy as jnp

    sd = jax.ShapeDtypeStruct((m,), jnp.float32)
    exp = jax.export.export(
        jax.jit(lambda a, b, c, d: modal_step(a, b, c, d, s, t_out)),
        platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(sd, sd, sd, sd)
    text = exp.mlir_module()
    gp, _, tile = padded_shape(m, t_out)
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert f"grid_x = {gp // tile} : i32" in text
    assert "num_warps = 4 : i32" in text


def test_modal_true_sinusoid_honesty(rng):
    """Why the phasor rotation is the recurrence: against the exact f64
    sinusoid bank defined by the stored (cos, sin) coefficients, the
    f32 rotation drifts only ~1e-6 of peak at 512 samples (it applies
    those very coefficients)."""
    m, t_out, s = 2048, 32, 512
    amp = rng.random(m, dtype=np.float32)
    w64 = 2 * np.pi * rng.random(m) * 0.45
    cw = np.cos(w64).astype(np.float32)
    sw = np.sin(w64).astype(np.float32)
    re = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    im = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)

    theta = np.arctan2(sw.astype(np.float64), cw.astype(np.float64))
    r = np.hypot(cw.astype(np.float64), sw.astype(np.float64))
    n = np.arange(1, s + 1)[:, None]
    phases = theta[None, :] * n
    radii = r[None, :] ** n
    vals = amp.astype(np.float64) * radii * (
        re * np.cos(phases) - im * np.sin(phases)
    )
    exact = vals.reshape(s, m // t_out, t_out).sum(axis=1).T  # (T, S)
    rot = modal_reference(amp, cw, sw, re, im, s, t_out)
    assert np.abs(rot - exact).max() / np.abs(exact).max() < 1e-5


def test_model_runs_the_xla_form_on_the_cpu(small_cfg):
    """No Triton kernel compiles for the CPU, so the benchmark runs the
    scan there and says so; the kernel never runs interpreted outside
    tests."""
    from gpuaudiobench_jax.registry import create_benchmark

    b = create_benchmark("ModalFilterBank", small_cfg)
    b.setup()
    assert b.metadata()["kernel"] == "xla"
    assert b.validate().passed


@pytest.mark.gpu
@pytest.mark.parametrize("m,t_out", SHAPES + [(1 << 20, 32)])
def test_modal_triton_on_the_card(gpu_device, rng, m, t_out):
    """The kernel compiled for the card matches the XLA scan."""
    s = 512 if m == 1 << 20 else 64
    amp, cw, sw, re, im = _bank(rng, m)
    ref, _, _ = modal_bank_xla(amp, cw, sw, re, im, s, t_out)
    out, _, _ = modal_step(cw, sw, amp * re, amp * im, s, t_out)
    peak = np.abs(np.asarray(ref)).max()
    assert np.abs(np.asarray(out) - np.asarray(ref)).max() <= 1e-4 * peak


@pytest.mark.gpu
def test_model_runs_the_kernel_on_the_card(gpu_device, small_cfg):
    from gpuaudiobench_jax.registry import create_benchmark

    b = create_benchmark("ModalFilterBank", small_cfg)
    b.setup()
    assert b.metadata()["kernel"] == "triton"
    assert b.validate().passed
