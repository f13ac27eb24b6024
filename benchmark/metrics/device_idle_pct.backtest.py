"""``device_idle_pct.backtest``: share (%) of the untraced seconds per
64-date chunk in which the card did nothing
(``benchmark.trace.device_idle_pct``)."""
from benchmark import trace


def read(r):
    return trace.device_idle_pct(r, "chunk")
