"""Discrete averaging measures over shadowing paths.

Port of :mod:`shadowing_tpu.stats.proba`: weighted mean / standard deviation
over the k-closest-paths axis; :class:`Softmax` gives each path the
Gaussian-kernel weight ``w_i ∝ exp(-d_i² / (2 η²))`` of its distance.
"""
from __future__ import annotations

import torch

from shadowing_tpu_torch.array_types import Array, as_tensor


class DiscreteProba:
    """A (possibly data-dependent) discrete measure over one array axis."""

    def weights_like(self, x: Array, axis: int) -> torch.Tensor:
        """Normalised weights broadcastable against ``x``, summing to 1 over ``axis``."""
        raise NotImplementedError

    def avg(self, x: Array, axis: int) -> torch.Tensor:
        x = as_tensor(x)
        return (self.weights_like(x, axis) * x).sum(dim=axis)

    def std(self, x: Array, axis: int) -> torch.Tensor:
        x = as_tensor(x)
        w = self.weights_like(x, axis)
        m = (w * x).sum(dim=axis, keepdim=True)
        var = (w * (x - m) ** 2).sum(dim=axis)
        return torch.sqrt(torch.clamp(var, min=0.0))


class Uniform(DiscreteProba):
    """Plain average over the paths axis."""

    def weights_like(self, x: Array, axis: int) -> torch.Tensor:
        x = as_tensor(x)
        return torch.ones_like(x) / x.shape[axis]


class Softmax(DiscreteProba):
    """Gaussian-kernel weights of path distances with bandwidth ``eta``."""

    def __init__(self, distances: Array, eta: float):
        if eta is None or eta <= 0:
            raise ValueError("Softmax averaging requires a bandwidth eta > 0")
        self.distances = as_tensor(distances)
        self.eta = float(eta)

    def weights_like(self, x: Array, axis: int) -> torch.Tensor:
        x = as_tensor(x)
        z = -0.5 * (self.distances.to(x.device) / self.eta) ** 2
        # align to x: drop trailing singleton axes beyond x's rank, then
        # append trailing singletons, so (B, k, 1) distances pair with a
        # (B, k) statistic instead of mis-broadcasting over the paths axis
        while z.ndim > x.ndim and z.shape[-1] == 1:
            z = z[..., 0]
        while z.ndim < x.ndim:
            z = z[..., None]
        ax = axis % x.ndim
        if z.shape[ax] != x.shape[ax]:
            raise ValueError(
                f"Softmax distances of shape {tuple(self.distances.shape)} do "
                f"not align with values of shape {tuple(x.shape)} over axis {axis}"
            )
        z = z - z.amax(dim=ax, keepdim=True)
        w = torch.exp(z)
        return w / w.sum(dim=ax, keepdim=True)
