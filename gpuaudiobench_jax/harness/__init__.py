from gpuaudiobench_jax.harness.statistics import (  # noqa: F401
    LatencyStats,
    calculate_statistics,
    csv_percentile,
)
from gpuaudiobench_jax.harness.validation import (  # noqa: F401
    ValidationData,
    ValidationStatus,
    compare_abs,
    compare_rel,
)
from gpuaudiobench_jax.harness.base import Benchmark, BenchmarkResult  # noqa: F401
from gpuaudiobench_jax.harness.runner import run_benchmark  # noqa: F401
