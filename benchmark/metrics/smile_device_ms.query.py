"""``smile_device_ms.query``: device milliseconds per query charged to
``psmc.smile`` (the winners' weights and price paths) and its three
phases, ``psmc.smile.knots`` (``sigma_T``, strikes and regression knots),
``psmc.smile.regress`` (the backward Hedged-MC regressions) and
``psmc.smile.vols`` (the Black-Scholes inversions) (``pricing/hedged_mc.py``,
``engine._smiles``; ``benchmark.spans``)."""
from benchmark import spans

SPANS = ("psmc.smile", "psmc.smile.knots", "psmc.smile.regress",
         "psmc.smile.vols")


def read(r):
    return spans.device_ms(r, "query", SPANS)
