"""``synth_launches.generate``: device kernels per Adam step in the traced
call, the first segment of one 2,048-seed shard (its seeds' draw and last
loss included) (``benchmark.trace.launches``)."""
from benchmark import trace


def read(r):
    return trace.launches(r, "step")
