"""The port's own spans and counters, read beside the benchmark's trace.

The port names stretches of its host code with ``psmc.*`` spans
(``shadowing_tpu_torch.utils.profiling.span``): under the benchmark's
``torch.profiler`` each lands in the Chrome trace as a ``user_annotation``
on the host, beside the kernels, and :func:`trace.parse`
keeps it among the host operations of a :class:`trace.Reading`. A device
operation is charged to the innermost ``psmc.*`` span around the host call
that launched it. The reading keeps no CUPTI correlation ids, so launches
are paired with device operations by order, kind by kind: on the port's
one stream the n-th kernel launched is the n-th kernel run, and likewise
for copies and sets.

Two faults of the trace are mended on the way, both found from the rule
that no operation starts before its launch:

- The host's and the device's clocks can drift apart within one trace
  (the device's operations seen up to 1.8 ms before their launches after
  0.3 s, growing linearly, on an H100 with torch 2.11). The lower
  envelope of (start - launch) over the copies and sets, which no library
  launches out of sight, is fitted by a line; where it is negative, the
  device's starts are moved onto the host's clock by it.
- A library may launch with ``cuLaunchKernel`` (cuBLAS's sgemm in
  ``_prep_context``), a call whose category the reading does not keep.
  Such a kernel shows itself by starting more than :data:`SLACK_US` before the
  next runtime launch left to pair: it takes no launch, and is charged to
  the span at that launch or at its own start, whichever is earlier.

The counters (``shadowing_tpu_torch.utils.profiling.counters``) are read
from the port itself, in the run's process, when the per-layer readers run
after the traced segment; they cover the whole run so far (set-up, window
and traced segment).

Every reader returns ``None`` for a reading of another unit, or where the
trace holds no ``psmc.*`` span (a port without them) or the port keeps no
counter store.
"""
from __future__ import annotations

import bisect

PREFIX = "psmc."
#: host calls that put one operation on the device, by that operation's
#: category in the trace
LAUNCHES = {"kernel": ("cudaLaunchKernel",),
            "gpu_memcpy": ("cudaMemcpyAsync",),
            "gpu_memset": ("cudaMemsetAsync",)}
NO_SPAN = "(no span)"
#: microseconds an operation may seem to start before the launch it is
#: paired with (what the clock fit leaves) before that launch counts as
#: another operation's
SLACK_US = 50.0
#: stretches of the trace whose least (start - launch) make the envelope
WINDOWS = 16


def psmc_spans(r) -> list:
    """The ``psmc.*`` spans ``(name, start_us, end_us)``, by start, the
    enclosing span before the one it encloses."""
    spans = [(n, s, s + d) for n, s, d in r.host if n.startswith(PREFIX)]
    return sorted(spans, key=lambda sp: (sp[1], -sp[2]))


class Innermost:
    """The innermost span around a host time. Spans of one thread nest, so
    it is the latest-starting span that has not ended."""

    def __init__(self, spans: list):
        self.spans = spans
        self.starts = [sp[1] for sp in spans]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t)
        for sp in reversed(self.spans[:i]):
            if sp[2] >= t:
                return sp
        return None


def _calls(r) -> dict:
    """The host starts of the launching calls, by the category of what
    they launch."""
    return {cat: sorted(s for n, s, _ in r.host if n in names)
            for cat, names in LAUNCHES.items()}


def envelope(points: list):
    """``(a, b)`` of the line ``a + b * t`` under ``(t, lag)`` points: the
    least lag of each of :data:`WINDOWS` stretches, fitted by least
    squares, dropping stretches more than :data:`SLACK_US` above the fit
    (where the device never waited for the host)."""
    lo, hi = min(t for t, _ in points), max(t for t, _ in points)
    width = (hi - lo) / WINDOWS or 1.0
    least: dict = {}
    for t, lag in points:
        w = min(int((t - lo) / width), WINDOWS - 1)
        if w not in least or lag < least[w][1]:
            least[w] = (t, lag)
    pts = list(least.values())
    while True:
        mt = sum(t for t, _ in pts) / len(pts)
        ml = sum(lag for _, lag in pts) / len(pts)
        var = sum((t - mt) ** 2 for t, _ in pts)
        b = (sum((t - mt) * (lag - ml) for t, lag in pts) / var
             if var > 0 else 0.0)
        a = ml - b * mt
        keep = [(t, lag) for t, lag in pts if lag - (a + b * t) <= SLACK_US]
        if len(keep) == len(pts) or len(keep) < 2:
            return a, b
        pts = keep


def host_ops(r) -> list:
    """The device operations, in order, with their starts on the host's
    clock: where some copy or set seems to start before its launch, moved
    by the negative part of the copies' and sets' envelope of (start -
    launch); else as the trace has them."""
    calls = _calls(r)
    points = []
    for cat in ("gpu_memcpy", "gpu_memset"):
        starts = sorted(op[2] for op in r.ops if op[1] == cat)
        points += [(s, s - t) for s, t in zip(starts, calls[cat])]
    if not points or min(lag for _, lag in points) >= 0:
        return sorted(r.ops, key=lambda op: op[2])
    a, b = envelope(points)
    return sorted(((n, c, s + max(0.0, -(a + b * s)), d)
                   for n, c, s, d in r.ops), key=lambda op: op[2])


def launch_times(r) -> list:
    """``(op, host start_us of its launch)`` for every device operation
    (from :func:`host_ops`), paired by order within each kind. An
    operation that starts more than :data:`SLACK_US` before the next
    launch left to pair was launched where the reading cannot see: it gets
    the earlier of its start and that launch, a bound on its launch's
    time, and the launch stays for the next operation."""
    calls = _calls(r)
    taken = {cat: 0 for cat in LAUNCHES}
    out = []
    for op in host_ops(r):
        cat, start = op[1], op[2]
        i, starts = taken.get(cat, 0), calls.get(cat, [])
        if i < len(starts) and starts[i] <= start + SLACK_US:
            out.append((op, starts[i]))
            taken[cat] = i + 1
        else:
            out.append((op, min(starts[i], start) if i < len(starts)
                        else start))
    return out


def attribute(r) -> list:
    """``(op, name of the innermost psmc span around its launch)``, the
    name :data:`NO_SPAN` where there is none."""
    inner = Innermost(psmc_spans(r))
    out = []
    for op, t in launch_times(r):
        sp = inner.at(t)
        out.append((op, sp[0] if sp else NO_SPAN))
    return out


def device_s_by_span(r) -> dict:
    """Device seconds (kernels, copies, sets) by innermost span."""
    by: dict = {}
    for op, name in attribute(r):
        by[name] = by.get(name, 0.0) + op[3] / 1e6
    return by


class Busy:
    """The union of the device operations' intervals, and how much of a
    host interval it covers."""

    def __init__(self, ops):
        self.union: list = []
        for s, e in sorted((s, s + d) for _, _, s, d in ops):
            if self.union and s <= self.union[-1][1]:
                self.union[-1][1] = max(self.union[-1][1], e)
            else:
                self.union.append([s, e])
        self.starts = [u[0] for u in self.union]

    def idle(self, a: float, b: float) -> float:
        """Microseconds of ``[a, b]`` outside the union."""
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        busy = 0.0
        for s, e in self.union[i:]:
            if s >= b:
                break
            busy += max(0.0, min(e, b) - max(s, a))
        return (b - a) - busy


def idle_s_by_span(r) -> dict:
    """Device-idle seconds (outside the union of device operations) from
    the first span's start to the last span's end, by the innermost
    ``psmc.*`` span over them, :data:`NO_SPAN` outside every span."""
    spans = psmc_spans(r)
    if not spans:
        return {}
    busy = Busy(host_ops(r))
    cuts = sorted({t for sp in spans for t in sp[1:]})
    inner = Innermost(spans)
    by: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        idle = busy.idle(a, b)
        if idle > 0:
            sp = inner.at(0.5 * (a + b))
            name = sp[0] if sp else NO_SPAN
            by[name] = by.get(name, 0.0) + idle / 1e6
    return by


def device_ms(r, unit: str, names) -> float | None:
    """Device milliseconds per unit charged to the spans ``names``."""
    if r.unit != unit or not psmc_spans(r):
        return None
    by = device_s_by_span(r)
    return 1e3 * sum(by.get(name, 0.0) for name in names) / r.units


def idle_ms(r, unit: str, name: str) -> float | None:
    """Device-idle milliseconds per unit inside the host intervals of the
    span ``name``."""
    spans = psmc_spans(r)
    if r.unit != unit or not spans:
        return None
    busy = Busy(host_ops(r))
    idle = sum(busy.idle(s, e) for n, s, e in spans if n == name)
    return 1e3 * idle / 1e6 / r.units


def program_counters() -> dict | None:
    """The port's counters, or ``None`` where it keeps no store."""
    try:
        from shadowing_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read is not None else None


def certified_pct(r, unit: str) -> float | None:
    """Share (%) of the searched contexts that the first pass certified."""
    c = program_counters()
    if r.unit != unit or not c or not c.get("contexts"):
        return None
    return 100.0 * c.get("certified", 0) / c["contexts"]
