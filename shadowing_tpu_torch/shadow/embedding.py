"""Linear path embeddings as convolution kernel banks.

Port of :mod:`shadowing_tpu.shadow.embedding`: an embedding is a
``(d, C, w)`` kernel bank held as host numpy (the engine ships it to its
device once); embedding every sliding window of a ``(B, C, T)`` series is
one float32 ``F.conv1d`` (cross-correlation, no padding).

* :class:`PathEmbedding` — generic kernel bank, ``embed()`` applies it;
* :class:`Identity` — windows embed to themselves (``is_identity``);
* :class:`Foveal` — multiscale power-law suffix averages;
* :func:`embed_windows` — whole windows, one vector each (defined beside
  its kernel in :mod:`shadowing_tpu_torch.ops.finalize`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from shadowing_tpu_torch.array_types import Array, as_torch_f32, dim_bct, fp32_exact
from shadowing_tpu_torch.ops.finalize import embed_windows  # noqa: F401


def conv_embed(x: Array, kernel: Array) -> torch.Tensor:
    """Embed every sliding window of ``x``: ``(B, C, T) -> (B, T', d)``,
    ``out[b, t, i] = sum_{c, tau} x[b, c, t + tau] * kernel[i, c, tau]``,
    on ``x``'s device (the CPU for an array)."""
    device = x.device if isinstance(x, torch.Tensor) else "cpu"
    x = as_torch_f32(dim_bct(x), device)
    kernel = as_torch_f32(kernel, device)
    with fp32_exact():
        out = F.conv1d(x, kernel)                          # (B, d, T')
    return out.transpose(1, 2)


class PathEmbedding:
    """A linear embedding of path windows, represented by a kernel bank."""

    #: engines may skip the embedding convolution when windows embed to
    #: themselves (set by :class:`Identity`)
    is_identity: bool = False

    def __init__(self, kernel: Array):
        if isinstance(kernel, torch.Tensor):
            kernel = kernel.detach().cpu().numpy()
        kernel = np.asarray(kernel, dtype=np.float32)
        if kernel.ndim != 3:
            raise ValueError(f"kernel must be (d, C, w), got {kernel.shape}")
        self.kernel = kernel

    @property
    def dim(self) -> int:
        return self.kernel.shape[0]

    @property
    def width(self) -> int:
        return self.kernel.shape[-1]

    def __call__(self, x: Array) -> torch.Tensor:
        return self.embed(x)

    def embed(self, x: Array) -> torch.Tensor:
        """Embed all windows: ``(B, C, T) -> (B, T', d)``."""
        return conv_embed(x, self.kernel)

    def embed_context(self, x: Array) -> torch.Tensor:
        """Embed a context whose length equals the kernel width: ``(B, d)``."""
        x = dim_bct(x)
        if x.shape[-1] != self.width:
            raise ValueError(
                f"context length {x.shape[-1]} != embedding width {self.width}"
            )
        return self.embed(x)[:, 0, :]


class Identity(PathEmbedding):
    """Windows embed to themselves (kernel = identity matrix per channel)."""

    is_identity = True

    def __init__(self, dimension: int):
        super().__init__(np.eye(dimension, dtype=np.float32)[:, None, :])


class Foveal(PathEmbedding):
    """Multiscale foveal embedding: channel ``i`` sums the last
    ``n_i = int(alpha**(i+1))`` samples with weight ``n_i**(-beta)``."""

    def __init__(self, alpha: float, beta: float, max_context: int):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.max_context = int(max_context)
        dim = int(np.floor(np.log(max_context) / np.log(alpha)))
        kernel = np.zeros((dim, 1, max_context), dtype=np.float32)
        lengths = [int(alpha ** n) for n in range(1, dim + 1)]
        for i, n in enumerate(lengths):
            kernel[i, 0, max_context - n :] = float(n) ** (-beta)
        super().__init__(kernel)
        self.lengths = lengths
