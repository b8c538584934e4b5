"""Benchmark workload definitions (the 17 registered benchmarks).

Each module defines a Benchmark subclass wiring a device op from
gpuaudiobench_jax.ops to seeded test data, a NumPy CPU golden, and the
reference's tolerance/metric (SURVEY.md section 4 tolerance matrix).
"""
