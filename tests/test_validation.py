"""Validation engine tests."""

import numpy as np

from gpuaudiobench_jax.harness.validation import (
    ValidationStatus,
    compare_abs,
    compare_complex,
    compare_rel,
    spot_indices,
)


def test_abs_pass():
    a = np.zeros(100, np.float32)
    b = a + 1e-7
    v = compare_abs(b, a, 1e-5)
    assert v.status == ValidationStatus.SUCCESS
    assert v.samples_checked == 100
    assert v.max_error <= 1e-6


def test_abs_fail_counts_and_messages():
    a = np.zeros(100, np.float32)
    b = a.copy()
    b[3] = 1.0
    b[50] = 2.0
    v = compare_abs(b, a, 1e-5)
    assert v.status == ValidationStatus.FAILURE
    assert v.error_count == 2
    assert "2 of 100" in v.messages[0]
    # per-element messages capped at 10 (bench_base.cu:204)
    b[:] = 1.0
    v = compare_abs(b, a, 1e-5)
    assert len([m for m in v.messages if "error at index" in m]) == 10


def test_shape_mismatch_is_fatal():
    v = compare_abs(np.zeros(3), np.zeros(4), 1e-5)
    assert v.status == ValidationStatus.FATAL


def test_mode_none_skips():
    v = compare_abs(np.ones(4), np.zeros(4), 1e-5, mode="none")
    assert v.status == ValidationStatus.SKIPPED
    assert v.passed


def test_spot_mode_subsamples():
    a = np.zeros(10000, np.float32)
    b = a.copy()
    v = compare_abs(b, a, 1e-5, mode="spot", limit=128)
    assert v.samples_checked <= 129  # limit + final element
    # an error at the last element is always caught (GPUABenchmark.swift:564)
    b[-1] = 9.0
    v = compare_abs(b, a, 1e-5, mode="spot", limit=128)
    assert v.status == ValidationStatus.FAILURE


def test_spot_indices_include_last():
    idx = spot_indices(10000, 128)
    assert idx[-1] == 9999
    assert len(idx) <= 129


def test_rel_metric():
    ref = np.array([100.0, 0.0], np.float32)
    out = np.array([100.05, 1e-7], np.float32)
    v = compare_rel(out, ref, 1e-3)
    assert v.status == ValidationStatus.SUCCESS
    out2 = np.array([101.0, 0.0], np.float32)
    v = compare_rel(out2, ref, 1e-3)
    assert v.status == ValidationStatus.FAILURE


def test_rel_floor():
    # tiny absolute error at a near-zero golden passes with a floor
    ref = np.array([1e-9, 10.0], np.float32)
    out = np.array([2e-9, 10.0], np.float32)
    assert compare_rel(out, ref, 1e-3).status == ValidationStatus.FAILURE
    assert compare_rel(out, ref, 1e-3, floor=1e-3 * 10.0).status == (
        ValidationStatus.SUCCESS
    )


def test_complex_metric():
    re = np.array([1.0, 2.0], np.float32)
    im = np.array([0.5, -1.0], np.float32)
    v = compare_complex(re + 4e-4, im - 4e-4, re, im, 1e-3)
    assert v.status == ValidationStatus.SUCCESS  # |dre|+|dim| = 8e-4
    v = compare_complex(re + 6e-4, im - 6e-4, re, im, 1e-3)
    assert v.status == ValidationStatus.FAILURE
