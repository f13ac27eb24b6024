"""``launches.query``: device kernels in the traced segment per query (the
host's dispatch count) (``benchmark.trace.launches``)."""
from benchmark import trace


def read(r):
    return trace.launches(r, "query")
