"""``pass1_roofline.query``: share (%) of its roofline that pass 1 (K1 or
K2) reaches per query, at 3.35 TB/s and 989/3 TFLOP/s; nothing when no
pass-1 kernel ran (``benchmark.trace.pass1_roofline``)."""
from benchmark import trace


def read(r):
    return trace.pass1_roofline(r, "query")
