"""``certified_pct.backtest``: share (%) of the contexts searched in the run
so far that pass 2 certified at once (the port's counters ``certified``
over ``contexts``) (``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.certified_pct(r, "chunk")
