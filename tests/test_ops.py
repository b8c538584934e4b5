"""Device-op correctness tests against independent NumPy references."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpuaudiobench_jax.ops.conv import (
    conv1d_direct,
    conv1d_fft,
    precompute_ir_spectra,
)
from gpuaudiobench_jax.ops.dwg_arc import dwg_block_arc
from gpuaudiobench_jax.ops.elementwise import (
    copy_op,
    data_transfer_op,
    gain_op,
    gain_stats_op,
)
from gpuaudiobench_jax.ops.fft import rfft_batched
from gpuaudiobench_jax.ops.iir import iir_biquad_xla
from gpuaudiobench_jax.ops.modal import modal_bank_xla
from gpuaudiobench_jax.ops.rndmem import rndmem_gather
from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients


def test_copy_gain(rng):
    x = rng.standard_normal((4, 32), dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(copy_op(x)), x)
    np.testing.assert_allclose(np.asarray(gain_op(x, 2.0)), 2.0 * x, rtol=1e-7)


def test_gain_stats(rng):
    x = rng.standard_normal((4, 32), dtype=np.float32)
    out, stats = gain_stats_op(x, 0.5)
    np.testing.assert_allclose(np.asarray(out), 0.5 * x, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(stats)[:, 0], x.mean(axis=1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(stats)[:, 1], x.max(axis=1), rtol=0)


def test_data_transfer(rng):
    x = rng.random(100, dtype=np.float32)
    out = np.asarray(data_transfer_op(x, 250))
    np.testing.assert_array_equal(out[:100], x)
    idx = np.arange(100, 250, dtype=np.float32)
    np.testing.assert_allclose(
        out[100:], 0.5 + 0.5 * np.sin(idx * np.float32(0.001)), atol=1e-6
    )
    # shrink case
    out2 = np.asarray(data_transfer_op(x, 40))
    np.testing.assert_array_equal(out2, x[:40])


def _iir_ref(x, coeffs, state):
    b0, b1, b2, a1, a2 = (np.float64(c) for c in coeffs)
    z1 = state[:, 0].astype(np.float64)
    z2 = state[:, 1].astype(np.float64)
    y = np.empty(x.shape, np.float64)
    for n in range(x.shape[1]):
        w = x[:, n] - a1 * z1 - a2 * z2
        y[:, n] = b0 * w + b1 * z1 + b2 * z2
        z2 = z1
        z1 = w
    return y, np.stack([z1, z2], axis=1)


@pytest.mark.parametrize("impl", ["xla"])
def test_iir(rng, impl):
    x = rng.standard_normal((8, 64), dtype=np.float32)
    coeffs = np.array(biquad_lowpass_coefficients(0.25), np.float32)
    state = rng.standard_normal((8, 2), dtype=np.float32) * 0.1
    y, z = iir_biquad_xla(x, coeffs, state)
    y_ref, z_ref = _iir_ref(x, coeffs, state)
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(z), z_ref, atol=1e-4)


def test_conv1d_direct_clamp(rng):
    x = rng.standard_normal((4, 32), dtype=np.float32)
    ir = rng.standard_normal((4, 8), dtype=np.float32) * 0.1
    y = np.asarray(conv1d_direct(x, ir, "clamp"))
    for t in range(4):
        ref = np.convolve(x[t].astype(np.float64), ir[t].astype(np.float64))[:32]
        np.testing.assert_allclose(y[t], ref, atol=1e-5)


def test_conv1d_direct_bleed(rng):
    x = rng.standard_normal((4, 32), dtype=np.float32)
    ir = rng.standard_normal((4, 8), dtype=np.float32) * 0.1
    y = np.asarray(conv1d_direct(x, ir, "bleed"))
    flat = x.astype(np.float64).ravel()
    for t in range(4):
        base = t * 32
        ref = np.array(
            [
                sum(
                    ir[t, j] * flat[base + i - j]
                    for j in range(8)
                    if base + i - j >= 0
                )
                for i in range(32)
            ]
        )
        np.testing.assert_allclose(y[t], ref, atol=1e-5)


def test_conv1d_fft_matches_direct(rng):
    x = rng.standard_normal((4, 32), dtype=np.float32)
    ir = rng.standard_normal((4, 8), dtype=np.float32) * 0.1
    spec = precompute_ir_spectra(jnp.asarray(ir), 64)
    y = np.asarray(conv1d_fft(x, spec, 64, 32))
    for t in range(4):
        ref = np.convolve(x[t].astype(np.float64), ir[t].astype(np.float64))[:32]
        np.testing.assert_allclose(y[t], ref, atol=1e-5)


def test_rfft(rng):
    x = rng.standard_normal((4, 1024), dtype=np.float32)
    re, im = rfft_batched(x, 1024)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-3)
    np.testing.assert_allclose(np.asarray(im), ref.imag, atol=1e-3)


def test_modal(rng):
    m, t_out, s = 64, 8, 16
    amp = rng.random(m, dtype=np.float32)
    freq = rng.random(m, dtype=np.float32) * 0.45
    w = 2 * np.pi * freq
    cos_w = np.cos(w).astype(np.float32)
    sin_w = np.sin(w).astype(np.float32)
    sre = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    sim = (rng.random(m, dtype=np.float32) * 2 - 1).astype(np.float32)
    out, re_f, im_f = modal_bank_xla(amp, cos_w, sin_w, sre, sim, s, t_out)
    out = np.asarray(out)

    # scalar reference, mode-by-mode (Metal golden semantics)
    ref = np.zeros((t_out, s), np.float64)
    for mi in range(m):
        r, i2 = np.float64(sre[mi]), np.float64(sim[mi])
        for n in range(s):
            r, i2 = (
                r * cos_w[mi] - i2 * sin_w[mi],
                r * sin_w[mi] + i2 * cos_w[mi],
            )
            ref[mi % t_out, n] += amp[mi] * r
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_dwg(rng):
    g_count, s, max_len = 4, 32, 16
    lengths = np.array([5, 8, 12, 16], np.int32)
    in_taps = (lengths // 4).astype(np.int32)
    out_taps = (3 * lengths // 4).astype(np.int32)
    gains = rng.random(g_count, dtype=np.float32)
    refl = np.full(g_count, 0.99, np.float32)
    damp = np.full(g_count, 0.9999, np.float32)
    x = (rng.random(s, dtype=np.float32) * 2 - 1).astype(np.float32)
    fwd = np.zeros((g_count, max_len), np.float32)
    bwd = np.zeros((g_count, max_len), np.float32)

    # all four strings are shorter than the block: no long rows,
    # ceil(S / Lmin) fixed-point rounds
    out, fwd_o, bwd_o = dwg_block_arc(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp,
        n_long=0, n_rounds=-(-s // int(lengths.min())),
    )
    out = np.asarray(out)

    # scalar reference (bench_dwg.cu:356-399 semantics)
    ref = np.zeros(s, np.float64)
    f64 = fwd.astype(np.float64).copy()
    b64 = bwd.astype(np.float64).copy()
    for gid in range(g_count):
        L = int(lengths[gid])
        for n in range(s):
            cur = n % L
            bpos = (cur + L // 2) % L
            fsamp = f64[gid, cur] * damp[gid]
            bsamp = b64[gid, bpos] * damp[gid]
            if cur == in_taps[gid]:
                inj = x[n] * gains[gid]
                fsamp += inj
                bsamp += inj
            f64[gid, cur] = bsamp * refl[gid]
            b64[gid, bpos] = fsamp * refl[gid]
            if cur == out_taps[gid]:
                ref[n] += (fsamp + bsamp) * 0.5
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_dwg_output_structurally_zero(rng):
    """Reference quirk, pinned (models/dwg.py docstring): the walk
    scheme of bench_dwg.cu:30-57 confines energy to closed
    (fwd[c], bwd[c+L/2]) cell pairs; injection lands in the L/4 pair,
    the output reads the disjoint 3L/4 pair, so the output is exactly
    zero for EVERY block while the rails ring. If this assertion ever
    fires, the kernel's update order stopped matching the reference."""
    from gpuaudiobench_jax.models.dwg import dwg_reference

    g_count, s, max_len = 8, 64, 48
    lengths = (8 + rng.integers(0, 40, g_count)).astype(np.int32)
    in_taps = (lengths // 4).astype(np.int32)
    out_taps = (3 * lengths // 4).astype(np.int32)
    gains = (0.5 + rng.random(g_count, dtype=np.float32)).astype(np.float32)
    refl = np.full(g_count, 0.99, np.float32)
    damp = np.full(g_count, 0.9999, np.float32)
    x = (rng.random(s, dtype=np.float32) * 2 - 1).astype(np.float32)
    fwd = np.zeros((g_count, max_len), np.float32)
    bwd = np.zeros((g_count, max_len), np.float32)
    for _ in range(5):  # carried rails across blocks, like the harness
        out, fwd, bwd = dwg_reference(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp
        )
        assert np.all(out == 0.0)
    # ...but the rails carry real energy (the correctness evidence the
    # validation actually relies on).
    assert np.abs(fwd).max() > 0 and np.abs(bwd).max() > 0
    # The closed-2-cycle argument: out-tap pair cells stay exactly 0
    # when the taps differ (they do for every L >= 8: 3L/4 != L/4).
    rows = np.arange(g_count)
    assert np.all(fwd[rows, out_taps] == 0.0)
    pool = rng.random(1000, dtype=np.float32)
    ph = np.array([0, 100, 500, 900], np.int32)
    template = np.zeros((4, 16), np.float32)
    out = np.asarray(rndmem_gather(pool, ph, template))
    assert out.shape == (16, 4)
    for t in range(4):
        np.testing.assert_array_equal(out[:, t], pool[ph[t] : ph[t] + 16])


def test_test_patterns():
    from gpuaudiobench_jax.utils.data import generate_test_pattern

    for p in ("zeros", "ones", "ramp", "sine", "noise", "pink", "impulse",
              "step"):
        v = generate_test_pattern(64, p)
        assert v.shape == (64,) and v.dtype == np.float32
    pink = generate_test_pattern(256, "pink")
    assert np.abs(pink).max() <= 1.0
    imp = generate_test_pattern(8, "impulse")
    assert imp[0] == 1.0 and imp[1:].sum() == 0


def test_kaiser_window_ir():
    """Kaiser joins the window set (BenchmarkUtilities.swift:299-326);
    standard I0 form: unity at center, symmetric, tapering to
    1/I0(beta) at the edges, L1-normalized like every other window."""
    from gpuaudiobench_jax.utils.data import generate_impulse_response

    ir = generate_impulse_response(101, 0.25, window="kaiser")
    assert ir.shape == (101,) and ir.dtype == np.float32
    assert abs(np.abs(ir).sum() - 1.0) < 1e-5  # L1-normalized
    # Window shape checks on the raw window (reconstruct by dividing
    # out the rectangular IR).
    rect = generate_impulse_response(101, 0.25, window="rectangular")
    assert np.abs(ir).max() > 0
    # Beta controls edge suppression: larger beta -> relatively smaller
    # edge taps than rectangular.
    k_edge = abs(ir[0] / ir[50])
    r_edge = abs(rect[0] / rect[50])
    assert k_edge < r_edge * 0.1
    with pytest.raises(ValueError):
        generate_impulse_response(64, 0.25, window="nope")


@pytest.mark.parametrize("m", [4, 16, 32])
@pytest.mark.parametrize("fc", [0.25, 0.0625, 0.01])
def test_iir_blockstate_matches_sequential(rng, m, fc):
    """The block-state form is the SAME filter: y within 1e-5 abs and
    state within its 1e-3 contract of the sequential f32 reference,
    including near-unit-circle poles (fc=0.01) and carried state
    across blocks."""
    from gpuaudiobench_jax.ops.iir import (
        blockstate_tables,
        iir_biquad_blockstate,
    )
    from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients

    coeffs = biquad_lowpass_coefficients(fc)
    x = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    z = rng.uniform(-0.5, 0.5, (8, 2)).astype(np.float32)
    taps, u = blockstate_tables(coeffs, m)
    c = jnp.asarray(np.array(coeffs, np.float32))
    yd, zd = x, z
    yr, zr = x, z
    for _ in range(3):  # carried state across 3 blocks
        yd, zd = iir_biquad_blockstate(
            jnp.asarray(x), c, jnp.asarray(taps), jnp.asarray(u), zd)
        yr, zr = _iir_ref(x, coeffs, zr)
    assert np.abs(np.asarray(yd) - yr).max() < 1e-5
    assert np.abs(np.asarray(zd) - zr).max() < 1e-3
