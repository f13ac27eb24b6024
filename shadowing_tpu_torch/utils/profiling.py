"""Profiling and tracing helpers.

Port of :mod:`shadowing_tpu.utils.profiling`: per-phase wall timers on the
host clock that wait for the card (``torch.cuda.synchronize``) before they
stop, and a thin wrapper over ``torch.profiler`` that writes a Chrome trace
(viewable in Perfetto or ``chrome://tracing``).

Beside them, the program's own instrumentation: :func:`span` names a
stretch of host code in that trace (a ``psmc.*`` user annotation, on the
profiler's clock beside the kernels it launches) and costs one flag check
when no profiler runs; :func:`count` adds to one store of integer counters,
always on, fed only with values the host already holds.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Union

import torch

_ACCUM: Dict[str, list] = defaultdict(list)
_COUNTS: Dict[str, int] = defaultdict(int)
_NO_SPAN = contextlib.nullcontext()


def _cuda_device(sync) -> Union[torch.device, None]:
    """The CUDA device ``sync`` names (a tensor, a device or its name), or
    None when it names no CUDA device."""
    if sync is None:
        return None
    device = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    return device if device.type == "cuda" else None


@contextlib.contextmanager
def phase_timer(name: str, sync: object = None, verbose: bool = True,
                ) -> Iterator[None]:
    """Time a phase on the host clock. ``sync`` — a tensor, a device or a
    device name — makes the timer wait for that CUDA device's queued work
    before it stops; a CPU tensor or device needs no wait."""
    device = _cuda_device(sync)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        _ACCUM[name].append(dt)
        if verbose:
            print(f"[timer] {name}: {dt:.3f}s", flush=True)


def timings() -> Dict[str, dict]:
    """Accumulated phase statistics: count / total / mean seconds."""
    return {name: {"count": len(ts), "total_s": sum(ts),
                   "mean_s": sum(ts) / len(ts)}
            for name, ts in _ACCUM.items()}


def reset_timings() -> None:
    _ACCUM.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block — host ops, plus the
    card's kernels when CUDA is available — into
    ``log_dir/trace.json`` (Chrome trace format).

    Usage::

        with device_trace("traces/shadow"):
            obj.shadow(x, k=1024)
    """
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def profiler_enabled() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``with span("psmc.pass1"):`` — a named range of host code. Under a
    profiler it is ``torch.profiler.record_function(name)``, so the range
    lands in the trace as a ``user_annotation`` whose parent is the span
    around it on this thread, and the kernels launched inside it can be
    charged to it. With no profiler it is a shared do-nothing context: the
    check for a profiler is its whole cost. A span never synchronizes,
    allocates or reads a device value."""
    if not profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a host integer; never a device
    value)."""
    _COUNTS[name] += n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()
