"""``select_device_ms.query``: device milliseconds per query charged to
``psmc.pass2.select`` and ``psmc.pass2.final``: pass 2's block tournament,
its sort into flat order, the final tournament and the certification guard
(``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.device_ms(r, "query",
                           ("psmc.pass2.select", "psmc.pass2.final"))
