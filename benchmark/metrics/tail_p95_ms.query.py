"""``tail_p95_ms.query``: 95th percentile (linear) over every query of the
untraced window of its time on the host clock, as ``query_p50_ms``
(``benchmark.trace.call_percentile_ms``). Per layer, with no bound: its
runs spread wider than any end-to-end bound may be."""
from benchmark import trace


def read(r):
    return trace.call_percentile_ms(r, "query", 95)
