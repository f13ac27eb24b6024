"""``finalize_device_ms.query``: device milliseconds per query charged to
``psmc.finalize`` and ``psmc.aggregate``: the winners' extraction, exact
rescore and stable sort, and the weighted prediction (``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.device_ms(r, "query", ("psmc.finalize", "psmc.aggregate"))
