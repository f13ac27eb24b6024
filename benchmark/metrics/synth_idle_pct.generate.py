"""``synth_idle_pct.generate``: share (%) of the untraced seconds per Adam
step in which the card did nothing: one less the traced busy seconds per
step over the untraced seconds per step of the same call, the first
segment of one 2,048-seed shard run once untraced just before it is
traced (``benchmark.trace.device_idle_pct``)."""
from benchmark import trace


def read(r):
    return trace.device_idle_pct(r, "step")
