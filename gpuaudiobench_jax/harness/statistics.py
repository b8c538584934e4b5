"""Latency statistics.

Two percentile conventions coexist in the reference and both are kept:

* `calculate_statistics` ports cuda/bench_utils.cu:358-414: mean, median
  (mid-pair average for even n), sample std-dev (n-1), min/max, and
  linearly *interpolated* p95/p99 over (n-1)-scaled indices. Used for the
  printed results.
* `csv_percentile` ports the truncated-index convention of the CSV/JSON
  writers (cuda/globals.cu:86-88: sorted[int(n*p)]), so CSV rows are
  bit-comparable with the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass
class LatencyStats:
    mean: float = 0.0
    median: float = 0.0
    std_dev: float = 0.0
    min_val: float = 0.0
    max_val: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    count: int = 0


def interpolated_percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (cuda/bench_utils.cu:396-409)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    index = p / 100.0 * (n - 1)
    lower = int(math.floor(index))
    upper = int(math.ceil(index))
    if lower == upper:
        return sorted_vals[lower]
    weight = index - lower
    return sorted_vals[lower] * (1.0 - weight) + sorted_vals[upper] * weight


def csv_percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Truncated-index percentile used by the CSV/JSON writers
    (cuda/globals.cu:86-88): sorted[int(n*p)], clamped to the last element.
    """
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    idx = min(int(n * p), n - 1)
    return sorted_vals[idx]


def calculate_statistics(latencies: Sequence[float]) -> LatencyStats:
    """Port of BenchmarkUtils::calculateStatistics (bench_utils.cu:358-414).

    Uses the native C++ implementation (native/gpuab_native.cc) when the
    shared library is built; the Python path below is the fallback and
    the reference for the native one (tests assert bit-equality).
    """
    n = len(latencies)
    if n == 0:
        return LatencyStats()
    try:
        from gpuaudiobench_jax.utils import native as _native

        if _native.available():
            result = _native.calculate_statistics_native(latencies)
            if result is not None:
                return result
    except ImportError:
        pass

    sorted_vals = sorted(latencies)
    mean = sum(latencies) / n

    mid = n // 2
    if n % 2 == 0:
        median = (sorted_vals[mid - 1] + sorted_vals[mid]) / 2.0
    else:
        median = sorted_vals[mid]

    if n > 1:
        variance = sum((v - mean) ** 2 for v in latencies) / (n - 1)
    else:
        variance = 0.0

    return LatencyStats(
        mean=mean,
        median=median,
        std_dev=math.sqrt(variance),
        min_val=sorted_vals[0],
        max_val=sorted_vals[-1],
        p95=interpolated_percentile(sorted_vals, 95.0),
        p99=interpolated_percentile(sorted_vals, 99.0),
        count=n,
    )


def histogram(values: Sequence[float], bins: int = 30):
    """(counts, edges) latency histogram (webgpu Statistics.js histogram,
    default 30 bins; feeds tools/report.py)."""
    if not values:
        return [], []
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1e-12
    counts = [0] * bins
    for v in values:
        idx = min(int((v - lo) / span * bins), bins - 1)
        counts[idx] += 1
    edges = [lo + span * i / bins for i in range(bins + 1)]
    return counts, edges


def detect_outliers(values: Sequence[float], k: float = 1.5):
    """IQR outlier detection (webgpu Statistics.js detectOutliers):
    returns (outliers, low_fence, high_fence)."""
    n = len(values)
    if n < 4:
        return [], 0.0, 0.0
    s = sorted(values)
    q1 = interpolated_percentile(s, 25.0)
    q3 = interpolated_percentile(s, 75.0)
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    return [v for v in values if v < lo or v > hi], lo, hi


def stability_rating(values: Sequence[float]):
    """(coefficient_of_variation, rating) per webgpu Statistics.js:
    cv < 5% excellent, < 15% good, < 30% fair, else poor."""
    stats = calculate_statistics(values)
    if stats.mean == 0:
        return 0.0, "n/a"
    cv = stats.std_dev / stats.mean * 100.0
    if cv < 5.0:
        rating = "excellent"
    elif cv < 15.0:
        rating = "good"
    elif cv < 30.0:
        rating = "fair"
    else:
        rating = "poor"
    return cv, rating


def compare_runs(a: Sequence[float], b: Sequence[float]) -> float:
    """A/B improvement percent of mean latency, positive = b faster
    (webgpu Statistics.js compare)."""
    ma = sum(a) / len(a) if a else 0.0
    mb = sum(b) / len(b) if b else 0.0
    if ma == 0:
        return 0.0
    return (ma - mb) / ma * 100.0
