"""``after_pass1_device_ms.query``: device-busy milliseconds per query
outside pass 1: pass 2, selection, finalize and aggregation
(``benchmark.trace.after_pass1_device_ms``)."""
from benchmark import trace


def read(r):
    return trace.after_pass1_device_ms(r, "query")
