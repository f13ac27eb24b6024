"""Path distances in embedding space.

Port of :mod:`shadowing_tpu.shadow.distance`. Distances that decompose over
the inner product expose the quadratic expansion
``‖x - y‖² = ‖x‖² - 2⟨x, y⟩ + ‖y‖²``: selection needs only the per-context
monotone score, and exact distances are recomputed on the winners.
``kernel_score_form`` (the JAX ``pallas_score_form``) marks distances whose
score is exactly ``y_norm2 - 2 * cross``, the form the pass-1 kernels
compute.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array, as_tensor, as_torch_f32
from shadowing_tpu_torch.ops.topk import merge_min, topk_min


class PathDistance:
    """Base distance: ``forward`` evaluates directly; expansion distances
    also implement ``score`` / ``finalize``."""

    #: True if ``score`` / ``finalize`` implement the quadratic expansion
    supports_expansion: bool = False
    #: True if the selection score is exactly ``y_norm2 - 2 * cross``
    kernel_score_form: bool = False

    def __call__(self, x: Array, y: Array) -> torch.Tensor:
        return self.forward(x, y)

    def forward(self, x: Array, y: Array) -> torch.Tensor:
        """Direct distance over the trailing embedding axis (broadcasting)."""
        raise NotImplementedError

    def forward_host(self, x, y) -> np.ndarray:
        """``forward`` in host numpy at the inputs' dtype."""
        raise NotImplementedError

    def score(self, x_norm2, cross, y_norm2):
        """Monotone-in-distance selection score (per fixed context)."""
        raise NotImplementedError

    def finalize(self, x_norm2, score):
        """Distance value from a selection score."""
        raise NotImplementedError

    def forward_topk(
        self, x: Array, y: Array, k: int, n_splits: int = 1,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """k smallest distances between each ``x`` row and all ``y`` entries.

        :param x: ``(B1, ..., d)`` contexts (broadcast dims collapse to B1)
        :param y: ``(B2, s1, ..., d)`` candidates, streamed in ``n_splits``
            chunks of the first axis (results do not depend on the split)
        :return: ``(B1, k)`` distances and ``(B1, k, y.ndim - 1)`` indices
        """
        device = y.device if isinstance(y, torch.Tensor) else "cpu"
        x = as_torch_f32(x, device)
        y = as_torch_f32(y, device)
        B1, B2 = x.shape[0], y.shape[0]
        inner_shape = tuple(y.shape[1:-1])
        inner = int(np.prod(inner_shape, dtype=np.int64))
        chunk = -(-B2 // n_splits)
        dists = torch.full((B1, k), float("inf"), device=device)
        idces = torch.full((B1, k), torch.iinfo(torch.int64).max,
                           dtype=torch.int64, device=device)
        x_u = x.reshape((B1,) + (1,) * (y.ndim - 1) + (x.shape[-1],))
        for start in range(0, B2, chunk):
            d_c = self.forward(x_u, y[start : start + chunk][None]).reshape(B1, -1)
            v, i = topk_min(d_c, min(k, d_c.shape[1]))
            dists, idces = merge_min(dists, idces, v, i + start * inner, k)
        coords, rem = [], idces
        sizes = (B2,) + inner_shape
        for a, size in enumerate(sizes):
            stride = int(np.prod(sizes[a + 1 :], dtype=np.int64))
            coords.append((rem // stride) % size)
        return dists, torch.stack(coords, dim=-1)


class RelativeMSE(PathDistance):
    """``‖x - y‖ / ‖x‖`` over the embedding axis."""

    supports_expansion = True
    kernel_score_form = True

    def forward(self, x, y):
        x, y = as_tensor(x), as_tensor(y)
        return torch.linalg.vector_norm(x - y, dim=-1) / torch.linalg.vector_norm(x, dim=-1)

    def forward_host(self, x, y):
        x, y = np.asarray(x), np.asarray(y)
        return np.linalg.norm(x - y, axis=-1) / np.linalg.norm(x, axis=-1)

    def score(self, x_norm2, cross, y_norm2):
        return y_norm2 - 2.0 * cross

    def finalize(self, x_norm2, score):
        return torch.sqrt(torch.clamp(x_norm2 + score, min=0.0) / x_norm2)


class MSE(PathDistance):
    """Plain Euclidean distance ``‖x - y‖``."""

    supports_expansion = True
    kernel_score_form = True

    def forward(self, x, y):
        return torch.linalg.vector_norm(as_tensor(x) - as_tensor(y), dim=-1)

    def forward_host(self, x, y):
        return np.linalg.norm(np.asarray(x) - np.asarray(y), axis=-1)

    def score(self, x_norm2, cross, y_norm2):
        return y_norm2 - 2.0 * cross

    def finalize(self, x_norm2, score):
        return torch.sqrt(torch.clamp(x_norm2 + score, min=0.0))


class CosineDistance(PathDistance):
    """``1 - cos(x, y)``. Its selection score is not of the kernels' form,
    so the engine searches it with the direct oracle."""

    supports_expansion = True

    def forward(self, x, y):
        x, y = as_tensor(x), as_tensor(y)
        num = (x * y).sum(dim=-1)
        den = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
        return 1.0 - num / torch.clamp(den, min=1e-30)

    def forward_host(self, x, y):
        x, y = np.asarray(x), np.asarray(y)
        num = (x * y).sum(axis=-1)
        den = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
        return 1.0 - num / np.maximum(den, 1e-30)

    def score(self, x_norm2, cross, y_norm2):
        return -cross / torch.sqrt(torch.clamp(y_norm2, min=1e-30))

    def finalize(self, x_norm2, score):
        return 1.0 + score / torch.sqrt(torch.clamp(x_norm2, min=1e-30))
