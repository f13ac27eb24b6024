"""The benchmark's own ``torch.profiler`` profile and the reading of its
Chrome trace.

A traced run profiles a bounded number of units (backtest chunks or
queries) after its untraced window, and hands the per-layer readers
(``metrics/<name>.py``) a :class:`Reading`: the device operations of the
trace, their busy time (the union of their intervals), the units traced,
the untraced seconds per unit of the same run, and the layer's work per
unit, and the untraced window's call latencies on the host clock. The
profiler slows the host, so shares of the wall are taken against the
untraced window, never the traced one. The five kinds of per-layer
reading are here; each metric's file passes its unit (``chunk`` or
``query``), and a reading of another unit, or of a segment without the
work it reads, is ``None``.
"""
from __future__ import annotations

import bisect
import json
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import work

#: the port's pass-1 kernels, by the names they carry in the trace
PASS1 = ("blockmin_toeplitz", "blockmin_factored")
#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of host work a device gap can be put down to
HOST_CATS = ("cpu_op", "cuda_runtime", "python_function", "user_annotation")
TOP = 10
#: characters of an operation's name kept in the breakdown
NAME_CHARS = 120
#: host ops looked back over to find the one under a gap
SCAN = 256


@dataclass
class Reading:
    """What one traced segment shows. Times in seconds."""

    ops: list                   # (name, cat, start_us, dur_us) on the device
    host: list                  # (name, start_us, dur_us) on the host
    window_s: float             # host-clock length of the traced segment
    units: int                  # units traced
    unit: str                   # "chunk", "query" or "step"
    untraced_s_per_unit: float  # the same run's untraced seconds per unit
    pass1_bytes: float | None = 0.0  # pass 1's work per unit (benchmark.work),
    pass1_flops: float | None = 0.0  # None where no pass 1 runs
    latencies_s: list = field(default_factory=list)  # untraced window, per call
    busy_s: float = field(init=False)

    def __post_init__(self):
        self.busy_s = union_seconds([(s, d) for _, _, s, d in self.ops])

    def kernels(self, patterns=()) -> list:
        """The kernels, or those whose name holds one of ``patterns``."""
        return [op for op in self.ops if op[1] == "kernel"
                and (not patterns or any(p in op[0] for p in patterns))]

    def kernel_seconds(self, patterns) -> float:
        return sum(op[3] for op in self.kernels(patterns)) / 1e6


def union_seconds(intervals) -> float:
    """Seconds covered by ``(start_us, dur_us)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, d in sorted(intervals):
        if s + d > end:
            busy += s + d - max(s, end)
            end = s + d
    return busy / 1e6


def parse(trace: dict) -> tuple:
    """``(device ops, host ops)`` of a Chrome trace's complete events."""
    ops, host = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e.get("name", ""), cat, float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            host.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
    return ops, host


def profile(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler`` (host and device); returns the
    parsed trace and the host-clock seconds of ``fn``. The trace file lives
    in a temporary directory that is removed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return parse(trace), window


def breakdown(r: Reading) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between them by the innermost host operation under each gap's
    midpoint, at most :data:`TOP` of each, in seconds."""
    by_op: dict = {}
    for name, _, _, dur in r.ops:
        name = name[:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + dur / 1e6
    spans, end = [], float("-inf")
    for _, _, s, d in sorted(r.ops, key=lambda op: op[2]):
        if s > end > float("-inf"):
            spans.append((end, s))
        end = max(end, s + d)
    host = sorted(r.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_gap: dict = {}
    for a, b in spans:
        mid = 0.5 * (a + b)
        name = "(python)"
        # the latest-starting host op that covers mid is the innermost one
        i = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, i - SCAN) : i]):
            if h[1] + h[2] >= mid:
                name = h[0]
                break
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def pass1_roofline(r: Reading, unit: str):
    """Share (%) of its roofline that pass 1 reaches per unit: the least
    time of the layer's work (``benchmark.work``) over the device time of
    the pass-1 kernels."""
    seconds = r.kernel_seconds(PASS1)
    if r.unit != unit or seconds <= 0:
        return None
    bound, _ = work.bound_seconds(r.pass1_bytes, r.pass1_flops)
    return 100.0 * bound / (seconds / r.units)


def after_pass1_device_ms(r: Reading, unit: str):
    """Device-busy milliseconds per unit outside pass 1: the union of
    every device operation's interval, less the pass-1 kernels' time."""
    if r.unit != unit or not r.ops:
        return None
    return 1e3 * (r.busy_s - r.kernel_seconds(PASS1)) / r.units


def launches(r: Reading, unit: str):
    """Device kernels per unit (the host's dispatch count)."""
    kernels = r.kernels()
    if r.unit != unit or not kernels:
        return None
    return len(kernels) / r.units


def device_idle_pct(r: Reading, unit: str):
    """Share (%) of the untraced seconds per unit in which the card did
    nothing: one less the traced busy seconds per unit over the untraced
    seconds per unit of the same run."""
    if r.unit != unit or not r.ops:
        return None
    return 100.0 * (1.0 - (r.busy_s / r.units) / r.untraced_s_per_unit)


def call_percentile_ms(r: Reading, unit: str, q: float):
    """The ``q``-th percentile (linear) over every call of the untraced
    window of its host-clock time, in milliseconds."""
    if r.unit != unit or not r.latencies_s:
        return None
    return 1e3 * float(np.percentile(r.latencies_s, q))
