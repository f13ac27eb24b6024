"""Sliding-window correlation.

Port of :func:`shadowing_tpu.ops.sliding.sliding_dot`. The JAX module recasts
the correlation as a segment-by-banded-Toeplitz matmul to feed the TPU's
matrix unit; here it is one ``F.conv1d`` (a cross-correlation) in full
float32, TF32 off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from shadowing_tpu_torch.array_types import fp32_exact


def sliding_dot(
    y: torch.Tensor,      # (R, C, T)
    filt: torch.Tensor,   # (F, C, w)
    n_out: int,
) -> torch.Tensor:        # (R, F, n_out)
    """All sliding-window correlations ``out[r, f, t] = sum_{c,tau}
    y[r, c, t + tau] * filt[f, c, tau]`` for ``t < n_out``."""
    R, C, T = y.shape
    _, Cf, w = filt.shape
    if Cf != C:
        raise ValueError(f"channel mismatch: data C={C}, filter C={Cf}")
    if n_out > T - w + 1:
        raise ValueError(f"n_out={n_out} exceeds valid starts {T - w + 1}")
    with fp32_exact():
        return F.conv1d(y[:, :, : n_out + w - 1], filt)
