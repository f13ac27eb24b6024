"""Profiling and tracing helpers."""
from shadowing_tpu_torch.utils.profiling import (
    count,
    counters,
    device_trace,
    phase_timer,
    profiler_enabled,
    reset_counters,
    reset_timings,
    span,
    timings,
)
