"""Statistics engine tests (ports of cuda/bench_utils.cu:358-414 semantics)."""

import math

import numpy as np
import pytest

from gpuaudiobench_jax.harness.statistics import (
    calculate_statistics,
    csv_percentile,
    interpolated_percentile,
)


def test_empty():
    s = calculate_statistics([])
    assert s.count == 0
    assert s.mean == 0.0


def test_single_value():
    s = calculate_statistics([5.0])
    assert s.mean == 5.0
    assert s.median == 5.0
    assert s.std_dev == 0.0
    assert s.p95 == 5.0
    assert s.p99 == 5.0


def test_basic_stats():
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    s = calculate_statistics(vals)
    assert s.mean == pytest.approx(3.0)
    assert s.median == pytest.approx(3.0)
    assert s.min_val == 1.0
    assert s.max_val == 5.0
    # sample std dev (n-1): sqrt(10/4)
    assert s.std_dev == pytest.approx(math.sqrt(2.5))


def test_median_even():
    # even n: average of the two middle values (bench_utils.cu:381-385)
    s = calculate_statistics([1.0, 2.0, 3.0, 4.0])
    assert s.median == pytest.approx(2.5)


def test_interpolated_percentile_matches_numpy():
    vals = sorted(np.random.default_rng(0).random(101).tolist())
    for p in (50.0, 95.0, 99.0):
        assert interpolated_percentile(vals, p) == pytest.approx(
            float(np.percentile(vals, p, method="linear"))
        )


def test_csv_percentile_truncated_index():
    # cuda/globals.cu:86-88: sorted[int(n*p)]
    vals = sorted(float(i) for i in range(100))
    assert csv_percentile(vals, 0.50) == 50.0
    assert csv_percentile(vals, 0.95) == 95.0
    assert csv_percentile(vals, 0.99) == 99.0
    # index clamp at n-1
    assert csv_percentile([1.0, 2.0], 0.99) == 2.0


def test_percentiles_ordering():
    vals = np.random.default_rng(1).random(1000).tolist()
    s = calculate_statistics(vals)
    assert s.min_val <= s.median <= s.p95 <= s.p99 <= s.max_val


def test_histogram():
    from gpuaudiobench_jax.harness.statistics import histogram

    counts, edges = histogram([1.0, 1.0, 2.0, 3.0], bins=4)
    assert sum(counts) == 4
    assert len(edges) == 5
    assert counts[0] == 2  # both 1.0s in the first bin
    assert histogram([], 4) == ([], [])


def test_detect_outliers():
    from gpuaudiobench_jax.harness.statistics import detect_outliers

    vals = [1.0] * 20 + [100.0]
    out, lo, hi = detect_outliers(vals)
    assert out == [100.0]
    assert detect_outliers([1.0, 2.0])[0] == []


def test_stability_rating():
    from gpuaudiobench_jax.harness.statistics import stability_rating

    cv, rating = stability_rating([1.0, 1.01, 0.99, 1.0])
    assert rating == "excellent"
    cv, rating = stability_rating([1.0, 3.0, 0.2, 2.5])
    assert rating == "poor"


def test_compare_runs():
    from gpuaudiobench_jax.harness.statistics import compare_runs

    assert compare_runs([2.0, 2.0], [1.0, 1.0]) == pytest.approx(50.0)
    assert compare_runs([1.0], [2.0]) == pytest.approx(-100.0)


def test_csv_schema_mismatch_refused(tmp_path):
    """Appending rows under a different header must fail loudly, not
    silently corrupt the CSV (plain run then --pipelineDepth run, or a
    metal-schema run into a cuda-schema file)."""
    import pytest

    from gpuaudiobench_jax.config import BenchConfig
    from gpuaudiobench_jax.harness.base import BenchmarkResult
    from gpuaudiobench_jax.harness.output import write_csv_results
    from gpuaudiobench_jax.harness.statistics import calculate_statistics

    path = str(tmp_path / "r.csv")
    res = BenchmarkResult(benchmark_name="gain", buffer_size=512,
                          track_count=128, iterations=3)
    res.latencies = [1.0, 2.0, 3.0]
    res.statistics = calculate_statistics(res.latencies)
    write_csv_results(res, BenchConfig(), path)  # cuda schema, 13 cols
    with pytest.raises(ValueError, match="different CSV schema"):
        write_csv_results(res, BenchConfig(pipeline_depth=256), path)
    with pytest.raises(ValueError, match="different CSV schema"):
        write_csv_results(res, BenchConfig(csv_schema="metal"), path)
    # same schema appends fine
    write_csv_results(res, BenchConfig(), path)
    assert len(open(path).read().splitlines()) == 3
