"""Context managers: what is matched (in-context) vs predicted (out-context).

Port of :mod:`shadowing_tpu.shadow.context`. Selection helpers slice the
trailing axes of numpy arrays or torch tensors alike; ``conv_plan`` works on
the host numpy kernel and tells the engine which kernel to slide over the
dataset and how many window starts are valid.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array


class ContextManager:
    """Splits a series into the matched part and the predicted part."""

    def select_in_context(self, x: Array) -> Array:
        raise NotImplementedError

    def select_out_context(self, x: Array) -> Array:
        raise NotImplementedError

    def get_out_times(self) -> int:
        """Extra *time* samples to extract beyond the matched window."""
        raise NotImplementedError

    def out_channels(self) -> int:
        """Extra *channels* the dataset has beyond the matched channels."""
        return 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        """``(conv_kernel, n_valid_positions)`` for a ``(d, C, w)`` kernel
        applied to trajectories of length ``T``: window starts are restricted
        so the extracted path never crosses a trajectory boundary."""
        raise NotImplementedError


class PredictionContext(ContextManager):
    """Match the past, predict the next ``horizon`` steps."""

    def __init__(self, horizon: int | None = None):
        self.horizon = horizon

    def select_in_context(self, x: Array) -> Array:
        return x[..., : -self.horizon] if self.horizon else x

    def select_out_context(self, x: Array) -> Array:
        return x[..., -self.horizon :] if self.horizon else x

    def get_out_times(self) -> int:
        return self.horizon or 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        w = kernel.shape[-1]
        n_out = T - w - (self.horizon or 0) + 1
        if n_out <= 0:
            raise ValueError(
                f"trajectories of length {T} are too short for window {w} "
                f"+ horizon {self.horizon}"
            )
        return kernel, n_out


class ImputationContext(ContextManager):
    """Match the flanks ``(l, ·, r)`` of a window, predict the middle gap."""

    def __init__(self, portion: Tuple[int, int, int] | None = None):
        self.portion = portion

    def select_in_context(self, x: Array) -> Array:
        if self.portion is None:
            return x
        l, _, r = self.portion
        if isinstance(x, torch.Tensor):
            return torch.cat([x[..., :l], x[..., -r:]], dim=-1)
        return np.concatenate([x[..., :l], x[..., -r:]], axis=-1)

    def select_out_context(self, x: Array) -> Array:
        if self.portion is None:
            return x
        l, _, r = self.portion
        return x[..., l:-r]

    def get_out_times(self) -> int:
        return self.portion[1] if self.portion else 0

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        if self.portion is None:
            return kernel, T - kernel.shape[-1] + 1
        l, gap, r = self.portion
        if kernel.shape[-1] != l + r:
            raise ValueError(
                f"kernel width {kernel.shape[-1]} must equal l+r={l + r}"
            )
        gapped = np.concatenate(
            [kernel[..., :l],
             np.zeros(kernel.shape[:-1] + (gap,), kernel.dtype),
             kernel[..., l:]],
            axis=-1,
        )
        n_out = T - (l + gap + r) + 1
        if n_out <= 0:
            raise ValueError(f"trajectories of length {T} too short for {self.portion}")
        return gapped, n_out


class CrossChannelContext(ContextManager):
    """Match the first channels, predict the last ``out_context_channels``."""

    def __init__(self, out_context_channels: int):
        self.out_context_channels = out_context_channels

    def select_in_context(self, x: Array) -> Array:
        return x[..., : x.shape[-2] - self.out_context_channels, :]

    def select_out_context(self, x: Array) -> Array:
        return x[..., -self.out_context_channels :, :]

    def get_out_times(self) -> int:
        return 0

    def out_channels(self) -> int:
        return self.out_context_channels

    def conv_plan(self, kernel: np.ndarray, T: int) -> Tuple[np.ndarray, int]:
        zeros = np.zeros(kernel.shape[:-2] + (self.out_context_channels,
                                              kernel.shape[-1]), kernel.dtype)
        return (np.concatenate([kernel, zeros], axis=-2),
                T - kernel.shape[-1] + 1)
