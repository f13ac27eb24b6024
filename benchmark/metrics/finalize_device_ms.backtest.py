"""``finalize_device_ms.backtest``: device milliseconds per 64-date chunk
charged to ``psmc.finalize`` and ``psmc.aggregate``: the winners'
extraction, exact rescore and stable sort, and the weighted prediction
(``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.device_ms(r, "chunk", ("psmc.finalize", "psmc.aggregate"))
