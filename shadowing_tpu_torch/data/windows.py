"""Sliding-window extraction along the trailing time axis.

Port of :mod:`shadowing_tpu.data.windows`: windows of width ``w`` and stride
``s`` are stacked on a new axis inserted before the time axis, so a
``(..., T)`` input becomes ``(..., n_windows, w)``. A numpy array gets one
contiguous copy of a strided view; a tensor gets ``Tensor.unfold`` (a view
on the tensor's device, no copy).
"""
from __future__ import annotations

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array


def n_windows(T: int, w: int, s: int, offset: int = 0) -> int:
    """Number of complete windows of width ``w`` stride ``s`` in length ``T``."""
    usable = T - offset - w
    if usable < 0:
        return 0
    return usable // s + 1


def windows(x: Array, w: int, s: int, offset: int = 0) -> Array:
    """Return sliding windows of ``x`` along the last axis.

    :param x: numpy array or tensor ``(..., T)``
    :param w: window width
    :param s: stride between window starts
    :param offset: index of the first window start
    :return: ``(..., n_windows, w)``, of ``x``'s type
    """
    T = x.shape[-1]
    n = n_windows(T, w, s, offset)
    if n <= 0:
        raise ValueError(f"no complete window: T={T}, w={w}, s={s}, offset={offset}")
    if isinstance(x, torch.Tensor):
        return x[..., offset : offset + (n - 1) * s + w].unfold(-1, w, s)
    x = np.asarray(x)
    itemsize = x.strides[-1]
    view = np.lib.stride_tricks.as_strided(
        x[..., offset:], shape=x.shape[:-1] + (n, w),
        strides=x.strides[:-1] + (s * itemsize, itemsize), writeable=False)
    return view.copy()
