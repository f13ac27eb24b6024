"""Profiling and tracing helpers."""
from shadowing_tpu_torch.utils.profiling import (
    device_trace,
    phase_timer,
    reset_timings,
    timings,
)
