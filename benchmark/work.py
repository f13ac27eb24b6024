"""The work of pass 1, the layer that turns the dataset into the block
minima of each context's scores, counted from shapes alone.

The count is the layer's, not one implementation's: it stays the same
whatever cache (such as the factored responses ``E`` of one route) an
implementation builds.

* Bytes: each input read once, the output written once. The inputs are
  the dataset ``y (R, C, T)``, the window norms ``(R, n_out)`` and the
  contexts ``(B, C, w)``; the output is the block minima ``(B, R,
  ceil(n_out / 128))``. All float32.
* Operations: ``2 R n_out`` times the fewer multiply-adds per window of the
  two ways to form the cross terms from ``y``: ``B C w`` (each context's
  filter slid over ``y``) or ``d C w + B d`` (embed each window, then a
  dot product per context).
"""
from __future__ import annotations

from benchmark import peaks

BLOCK = 128


def pass1(R: int, C: int, T: int, n_out: int, B: int, w: int, d: int) -> tuple:
    """``(bytes, flops)`` of one pass-1 search of ``B`` contexts."""
    nbytes = 4 * (R * C * T + R * n_out + B * C * w + B * R * -(-n_out // BLOCK))
    flops = 2 * R * n_out * min(B * C * w, d * C * w + B * d)
    return nbytes, flops


def bound_seconds(nbytes: float, flops: float) -> tuple:
    """The least time the card could take, and which of the two binds."""
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = flops / peaks.FP32_CLASS_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
