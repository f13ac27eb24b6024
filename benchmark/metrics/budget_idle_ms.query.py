"""``budget_idle_ms.query``: milliseconds per query in which the card did
nothing while the host was inside ``psmc.budget``: the engine's queries of
the card's free memory (``engine._memory_budget``, ``engine._free_bytes``)
(``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.idle_ms(r, "query", "psmc.budget")
