"""``device_idle_pct.query``: share (%) of the untraced seconds per query
in which the card did nothing (``benchmark.trace.device_idle_pct``)."""
from benchmark import trace


def read(r):
    return trace.device_idle_pct(r, "query")
