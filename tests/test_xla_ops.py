"""The XLA forms of the suite's ops against their NumPy goldens, at the
shapes that exercise their edge cases: random-memory windows at every
CLI buffer size, waveguides longer and shorter than the block, biquad
cascades of every depth, direct convolution at unaligned track counts,
the block-state IIR at every chunk size, and FDTD rooms off the
reference size."""

import numpy as np
import pytest

from gpuaudiobench_jax.models.conv1d import conv1d_reference
from gpuaudiobench_jax.models.dwg import dwg_reference
from gpuaudiobench_jax.models.fdtd3d import fdtd3d_reference
from gpuaudiobench_jax.models.iir import iir_reference
from gpuaudiobench_jax.ops import fdtd3d as fd
from gpuaudiobench_jax.ops.rndmem import rndmem_gather
from gpuaudiobench_jax.utils.data import biquad_lowpass_coefficients


def _rndmem_golden(pool, playheads, s):
    return np.stack([pool[p:p + s] for p in playheads], axis=1)  # (S, T)


def test_rndmem_gather_edge_playheads(rng):
    """Block-aligned, end-of-pool and mid-row playheads copy exactly."""
    pool = rng.random(64 * 1024, dtype=np.float32)
    edge = [0, 1024, 513, 1000, 64 * 1024 - 512, 2047, 12345, 777,
            128, 127, 129, 64 * 1024 - 513, 64 * 1024 - 640, 255,
            64 * 1024 - 768, 511]
    ph = np.concatenate([
        np.array(edge, np.int32),
        rng.integers(0, 64 * 1024 - 512, 16).astype(np.int32),
    ])
    out = np.asarray(rndmem_gather(pool, ph, np.zeros((32, 512), np.float32)))
    np.testing.assert_array_equal(out, _rndmem_golden(pool, ph, 512))


@pytest.mark.parametrize("tracks,pool_kib", [(16, 16), (32, 32), (64, 16)])
def test_rndmem_gather_track_counts(rng, tracks, pool_kib):
    pool = rng.random(pool_kib * 1024, dtype=np.float32)
    ph = rng.integers(0, pool_kib * 1024 - 512, tracks).astype(np.int32)
    out = np.asarray(rndmem_gather(pool, ph,
                                   np.zeros((tracks, 512), np.float32)))
    np.testing.assert_array_equal(out, _rndmem_golden(pool, ph, 512))


def test_rndmem_gather_small_buffer(rng):
    pool = rng.random(50000, dtype=np.float32)
    ph = rng.integers(0, 49000, 16).astype(np.int32)
    out = np.asarray(rndmem_gather(pool, ph, np.zeros((16, 32), np.float32)))
    for i, p in enumerate(ph):
        np.testing.assert_array_equal(out[:, i], pool[p:p + 32])


@pytest.mark.parametrize("s", [32, 64, 128, 256, 1024])
def test_rndmem_gather_buffer_sizes(rng, s):
    """Every CLI buffer size, including windows ending at the pool's
    last sample."""
    logical = 32 * 1024
    pool = rng.random(logical, dtype=np.float32)
    ph = np.concatenate([
        np.array([0, 127, 128, 1023, logical - s, logical - s - 1],
                 np.int32),
        rng.integers(0, logical - s, 26).astype(np.int32),
    ])
    out = np.asarray(rndmem_gather(pool, ph, np.zeros((32, s), np.float32)))
    np.testing.assert_array_equal(out, _rndmem_golden(pool, ph, s))


def _dwg_setup(rng, s, lengths):
    lengths = np.array(lengths, np.int32)
    # pre-partition: long (L >= s) first, stable -- the model does this
    lengths = lengths[np.argsort(lengths < s, kind="stable")]
    n_long = int((lengths >= s).sum())
    shorts = lengths[lengths < s]
    n_rounds = int(-(-s // int(shorts.min()))) if shorts.size else 0
    g = len(lengths)
    max_len = int(lengths.max())
    params = (lengths, (lengths // 4).astype(np.int32),
              (3 * lengths // 4).astype(np.int32),
              rng.random(g, dtype=np.float32),
              np.full(g, 0.99, np.float32), np.full(g, 0.9999, np.float32))
    x = (rng.random(s, dtype=np.float32) * 2 - 1).astype(np.float32)
    fwd = (rng.random((g, max_len), dtype=np.float32) * 0.1).astype(np.float32)
    bwd = (rng.random((g, max_len), dtype=np.float32) * 0.1).astype(np.float32)
    return x, fwd, bwd, params, n_long, n_rounds


DWG_CASES = [
    # mixed long/short around S, incl. L == S and L just above/below
    (48, [100, 96, 48, 49, 5, 8, 33, 40, 47]),
    # all long (pure elementwise path)
    (32, [40, 64, 33, 32]),
    # all short (fixed-point rounds only)
    (64, [5, 8, 12, 63]),
    # unaligned waveguide count and lengths
    (48, [5, 8, 12, 16, 33, 40]),
]


@pytest.mark.parametrize("s,lengths", DWG_CASES)
def test_dwg_arc_matches_golden(rng, s, lengths):
    """Two chained arc blocks reproduce the per-sample NumPy golden,
    output and both rails (the carried-rail path included)."""
    from gpuaudiobench_jax.ops.dwg_arc import dwg_block_arc

    x, fwd, bwd, params, n_long, n_rounds = _dwg_setup(rng, s, lengths)
    ref_f, ref_b, f_o, b_o = fwd, bwd, fwd, bwd
    for _ in range(2):
        ref_out, ref_f, ref_b = dwg_reference(x, ref_f, ref_b, *params)
        out, f_o, b_o = dwg_block_arc(
            x, np.asarray(f_o), np.asarray(b_o), *params,
            n_long=n_long, n_rounds=n_rounds)
        np.testing.assert_allclose(np.asarray(out), ref_out, atol=1e-5)
        np.testing.assert_allclose(np.asarray(f_o), ref_f, atol=1e-6)
        np.testing.assert_allclose(np.asarray(b_o), ref_b, atol=1e-6)


@pytest.mark.parametrize("s,lengths", DWG_CASES[:3])
def test_dwg_stream_matches_positional(rng, s, lengths):
    """Chained dwg_stream_step blocks reproduce the chained positional
    golden exactly (the aligned carry is a re-representation, not an
    approximation)."""
    from gpuaudiobench_jax.ops.dwg_arc import dwg_stream_entry, dwg_stream_step

    x, fwd, bwd, params, n_long, n_rounds = _dwg_setup(rng, s, lengths)
    sf, sb = dwg_stream_entry(fwd, bwd, params[0], s)
    ref_f, ref_b = fwd, bwd
    for _ in range(3):
        ref_out, ref_f, ref_b = dwg_reference(x, ref_f, ref_b, *params)
        out, sf, sb = dwg_stream_step(
            x, np.asarray(sf), np.asarray(sb), *params,
            n_long=n_long, n_rounds=n_rounds)
        np.testing.assert_allclose(np.asarray(out), ref_out, atol=1e-6)


def _stage_coeffs(k, top=0.25, step=0.02):
    return np.stack([np.array(biquad_lowpass_coefficients(top - step * i),
                              np.float32) for i in range(k)])


@pytest.mark.parametrize("k,t,s", [(4, 8, 32), (10, 8, 32), (1, 8, 16),
                                   (4, 16, 64)])
def test_iir_cascade_matches_reference(rng, k, t, s):
    """iir_cascade_xla is the chain of float32 per-stage references,
    carried states included."""
    from gpuaudiobench_jax.ops.iir import iir_cascade_xla

    coeffs = _stage_coeffs(k, top=0.3)
    states = (rng.random((k, t, 2), dtype=np.float32) * 0.1).astype(np.float32)
    x = (rng.random((t, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    y, zs = x, []
    for i in range(k):
        y, z = iir_reference(y, coeffs[i], states[i])
        zs.append(z)
    yc, zc = iir_cascade_xla(x, coeffs, states)
    np.testing.assert_allclose(np.asarray(yc), y, atol=1e-5)
    np.testing.assert_allclose(np.asarray(zc), np.stack(zs), atol=1e-5)


@pytest.mark.parametrize("t,s,l", [(4, 32, 8), (130, 48, 16), (8, 64, 7)])
@pytest.mark.parametrize("mode", ["clamp", "bleed"])
def test_conv1d_direct_matches_golden(rng, t, s, l, mode):
    from gpuaudiobench_jax.ops.conv import conv1d_direct

    x = rng.standard_normal((t, s), dtype=np.float32)
    ir = (rng.standard_normal((t, l), dtype=np.float32) * 0.1
          ).astype(np.float32)
    out = np.asarray(conv1d_direct(x, ir, mode))
    np.testing.assert_allclose(out, conv1d_reference(x, ir, mode), atol=1e-5)


@pytest.mark.parametrize("tracks,s,m", [(8, 128, 128), (8, 256, 64),
                                        (640, 128, 16)])
def test_iir_blockstate_matches_sequential(rng, tracks, s, m):
    """The block-state form is the SAME filter as the float32 per-sample
    reference (<= 1e-5 abs, carried state across 3 blocks)."""
    import jax.numpy as jnp

    from gpuaudiobench_jax.ops.iir import (
        blockstate_tables,
        iir_biquad_blockstate,
    )

    coeffs = biquad_lowpass_coefficients(0.25)
    c = jnp.asarray(np.array(coeffs, np.float32))
    x = (rng.random((tracks, s), dtype=np.float32) * 2 - 1)
    z0 = (rng.random((tracks, 2), dtype=np.float32) - 0.5)
    taps, u = blockstate_tables(coeffs, m)
    zb, zr = jnp.asarray(z0), z0
    for _ in range(3):
        yb, zb = iir_biquad_blockstate(jnp.asarray(x), c, jnp.asarray(taps),
                                       jnp.asarray(u), zb)
        yr, zr = iir_reference(x, coeffs, zr)
    np.testing.assert_allclose(np.asarray(yb), yr, atol=1e-5)
    np.testing.assert_allclose(np.asarray(zb), zr, atol=1e-4)


@pytest.mark.parametrize("room", [8, 14, 50])
def test_fdtd_block_matches_reference(rng, room):
    """The fused scan reproduces the float32 NumPy simulation at the
    reference room and off it, receiver output and final pressure."""
    n = fd.grid_n(room)
    src, rcv = fd.source_pos(room), fd.receiver_pos(room)
    x = (rng.random((2, 8), dtype=np.float32) * 2 - 1).astype(np.float32)
    out, p, *_ = fd.fdtd3d_block(x, *fd.zero_fields(n), source=src,
                                 receiver=rcv)
    golden = fdtd3d_reference(x, n=n, source=src, receiver=rcv)
    np.testing.assert_allclose(np.asarray(out), golden, atol=1e-6)
    assert np.isfinite(np.asarray(p)).all()


def test_fdtd_blocks_chain(rng):
    """Two chained blocks equal one block over the concatenated input:
    the carried fields are the whole state."""
    room = 8
    n = fd.grid_n(room)
    kw = dict(source=fd.source_pos(room), receiver=fd.receiver_pos(room))
    x = (rng.random((1, 16), dtype=np.float32) * 2 - 1).astype(np.float32)
    whole, *_ = fd.fdtd3d_block(x, *fd.zero_fields(n), **kw)
    first, *fields = fd.fdtd3d_block(x[:, :8], *fd.zero_fields(n), **kw)
    second, *_ = fd.fdtd3d_block(x[:, 8:], *fields, **kw)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(first), np.asarray(second)], axis=1),
        np.asarray(whole), atol=1e-7)
