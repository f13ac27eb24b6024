"""``rescore_device_ms.backtest``: device milliseconds per 64-date chunk
charged to ``psmc.pass2.rescore``: pass 2's exact rescore of the selected
blocks (``csrc/rescore_candidates.cu`` on the card, its plain
``ops/search.py::_candidate_cross`` on the CPU) (``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.device_ms(r, "chunk", ("psmc.pass2.rescore",))
