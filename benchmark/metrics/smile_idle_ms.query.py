"""``smile_idle_ms.query``: milliseconds per query in which the card did
nothing while the host was inside ``psmc.smile``, the Hedged-MC smile
(``pricing/hedged_mc.py``, ``engine._smiles``; ``benchmark.spans``)."""
from benchmark import spans


def read(r):
    return spans.idle_ms(r, "query", "psmc.smile")
