"""``budget_idle_ms.backtest``: milliseconds per 64-date chunk in which the
card did nothing while the host was inside ``psmc.budget``: the engine's
queries of the card's free memory (``engine._memory_budget``,
``engine._free_bytes``) (``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.idle_ms(r, "chunk", "psmc.budget")
