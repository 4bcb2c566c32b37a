"""Benchmark harness (reference: benchmarks/ google-benchmark suite)."""
from .harness import (
    BenchResult,
    bench_active_sweep,
    bench_decompositions,
    bench_size_sweep,
    bench_structured_ik,
    bench_warm_start_trajectory,
    bench_box_single,
    bench_scaling,
    device_info,
    gpu_name_and_power,
    ik_batch,
    require_gpu,
    time_batch,
)

__all__ = [
    "BenchResult",
    "bench_active_sweep",
    "bench_decompositions",
    "bench_box_single",
    "bench_scaling",
    "bench_size_sweep",
    "bench_structured_ik",
    "bench_warm_start_trajectory",
    "device_info",
    "gpu_name_and_power",
    "ik_batch",
    "require_gpu",
    "time_batch",
]
