"""``smile_launches.query``: device operations (kernels, copies, sets) per
query launched inside ``psmc.smile`` or one of its phases
``psmc.smile.*``, the Hedged-MC smile (``pricing/hedged_mc.py``,
``engine._smiles``; ``benchmark.spans.attribute``)."""
from benchmark import spans


def read(r):
    if r.unit != "query" or not spans.psmc_spans(r):
        return None
    n = sum(1 for _, name in spans.attribute(r)
            if name == "psmc.smile" or name.startswith("psmc.smile."))
    return n / r.units
