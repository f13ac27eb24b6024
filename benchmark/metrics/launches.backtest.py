"""``launches.backtest``: device kernels in the traced segment per 64-date
chunk (the host's dispatch count) (``benchmark.trace.launches``)."""
from benchmark import trace


def read(r):
    return trace.launches(r, "chunk")
