"""The two arithmetics of the reference: float64, and TF32 for the control.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits. A tensor
core in TF32 mode rounds each operand of a product to it and accumulates in
float32; :func:`round_tf32` does the rounding (to nearest, ties to even),
so the control computes the same numbers on the CPU as on the card. Only
operands of products (matrix products, dot products, squares summed) are
rounded: elementwise work stays in float32, as it does on the card.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


def round_tf32(x):
    """``x`` (float32 numpy array or tensor) rounded to TF32."""
    if isinstance(x, torch.Tensor):
        b = x.to(torch.float32).contiguous().view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    b = (b + np.int32(0x0FFF) + ((b >> 13) & 1)) & np.int32(~0x1FFF)
    return b.view(np.float32)


@dataclass(frozen=True)
class Arith:
    """One arithmetic: its name, its dtypes and the rounding of operands."""

    name: str
    np_dtype: type
    torch_dtype: torch.dtype

    def q(self, x):
        """``x`` in this arithmetic's dtype, rounded for a product."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.torch_dtype)
        else:
            x = np.asarray(x, dtype=self.np_dtype)
        return round_tf32(x) if self.name == "tf32" else x

    def mm(self, a, b):
        """Matrix product of rounded operands (float32 or float64 sums)."""
        return self.q(a) @ self.q(b)

    def sumsq(self, x, axis=-1):
        """Sum of squares over ``axis``, as a dot product of ``x`` with
        itself."""
        x = self.q(x)
        if isinstance(x, torch.Tensor):
            return (x * x).sum(dim=axis)
        return (x * x).sum(axis=axis)

    def wsum(self, w, v, axis):
        """``sum(w * v)`` over ``axis``: a weighted sum is a dot product."""
        w, v = self.q(w), self.q(v)
        return (w * v).sum(axis=axis)


FLOAT64 = Arith("float64", np.float64, torch.float64)
TF32 = Arith("tf32", np.float32, torch.float32)
ARITHS = {a.name: a for a in (FLOAT64, TF32)}


@contextlib.contextmanager
def exact_products():
    """No TF32 in cuBLAS or cuDNN inside the block (the control rounds its
    operands itself); the previous settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
