"""tools/soak.py stream_state_rms: the evolving-leaves-only state
metric.

Stream bodies carry large CONSTANT
operands (input blocks, sample pools, IR spectra) alongside the real
state; the soak's drift detector must exclude them or a (T, S) input
block dilutes a (T, 2) biquad state's drift ~100x below visibility.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from soak import stream_state_rms  # noqa: E402


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def test_constant_leaf_excluded_from_state_rms():
    # A large carried constant (the input block) plus a small evolved
    # state: the metric must equal the state's own RMS, not the
    # size-weighted mix.
    rng = np.random.default_rng(42)
    x0 = rng.uniform(-1, 1, (128, 512)).astype(np.float32)
    z0 = np.zeros((128, 2), np.float32)
    # state two orders of magnitude quieter than the carried input
    z1 = (0.01 * rng.uniform(-1, 1, (128, 2))).astype(np.float32)
    got = float(stream_state_rms((x0, z1), (x0, z0)))
    assert got == pytest.approx(_rms(z1), rel=1e-6)
    # the diluted (all-leaves) value would be dominated by x0
    diluted = _rms(np.concatenate([x0.ravel(), z1.ravel()]))
    assert diluted > 50 * got


def test_unevolved_carry_falls_back_to_full_rms():
    # Nothing evolved yet (or a stateless carry): report the live
    # full-carry magnitude instead of 0, so the artifact stays flat
    # rather than reading as state death.
    x0 = np.linspace(-1, 1, 256, dtype=np.float32).reshape(2, 128)
    got = float(stream_state_rms((x0,), (x0,)))
    assert got == np.float32(_rms(x0))


def test_integer_leaves_ignored():
    # Playheads/counters are int leaves; they must not enter the RMS
    # even when they evolve.
    ph0 = np.arange(8, dtype=np.int32)
    ph1 = ph0 + 512
    z0 = np.zeros(4, np.float32)
    z1 = np.full(4, 0.25, np.float32)
    got = float(stream_state_rms((ph1, z1), (ph0, z0)))
    assert got == np.float32(_rms(z1))


def test_all_int_carry_reports_zero():
    ph0 = np.arange(8, dtype=np.int32)
    assert float(stream_state_rms((ph0 + 1,), (ph0,))) == 0.0


def test_partial_evolution_is_detected_despite_giant_constant():
    # The regression this metric exists for: a tiny drift on the real
    # state must move the reading even when a 512x-larger constant
    # rides along.
    pool = np.full((4096, 128), 0.5, np.float32)
    z0 = np.full((128,), 1.0, np.float32)
    z_drift = z0 * 1.01
    base = float(stream_state_rms((pool, z0 * 1.0000001), (pool, z0)))
    drifted = float(stream_state_rms((pool, z_drift), (pool, z0)))
    assert drifted / base > 1.009  # the 1% drift reads as ~1%
