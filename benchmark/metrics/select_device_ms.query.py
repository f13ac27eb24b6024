"""``select_device_ms.query``: device milliseconds per query charged to
``psmc.pass2.select`` and ``psmc.pass2.final``: pass 2's two selections of
the k lowest (``ops/topk.py::select_lowest``: the radix select of
``csrc/select_lowest.cu`` on the card)
(``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.device_ms(r, "query",
                           ("psmc.pass2.select", "psmc.pass2.final"))
