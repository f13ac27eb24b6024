"""Direct search: embed every window of the dataset, score it against each
context, keep the k smallest.

A window of trajectory ``r`` starting at ``t`` is ``y[r, :, t : t + w]``;
the valid starts are ``t < n_out = T - w - horizon + 1``, so its future of
``horizon`` samples stays inside the trajectory. Its flat id is
``r * n_out + t``. The embedding is a linear filter bank ``(d, C, w)``
(:func:`embedding_kernel`), the distance the relative Euclidean distance
``|E(x) - E(y)| / |E(x)|`` between embedded context and window.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import Arith, exact_products

#: windows scored per block of the scan (bounds its device memory)
BLOCK_WINDOWS = 1 << 20


def embedding_kernel(spec: dict) -> np.ndarray:
    """The filter bank ``(d, C, w)`` float64 of an embedding spec.

    ``identity``: ``w = d``, one tap per filter. ``foveal``: filter ``i``
    of ``d = floor(log(w) / log(alpha))`` averages the last ``n_i =
    int(alpha ** (i + 1))`` samples with weight ``n_i ** -beta``."""
    if spec["kind"] == "identity":
        dim = int(spec["dim"])
        return np.eye(dim)[:, None, :]
    if spec["kind"] == "foveal":
        alpha, beta, w = float(spec["alpha"]), float(spec["beta"]), int(spec["width"])
        dim = int(np.floor(np.log(w) / np.log(alpha)))
        kernel = np.zeros((dim, 1, w))
        for i in range(dim):
            n = int(alpha ** (i + 1))
            kernel[i, 0, w - n :] = float(n) ** (-beta)
        return kernel
    raise ValueError(f"unknown embedding {spec['kind']!r}")


def _windows(y_rows: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """``(rows * n_out, C * w)`` copy of every window of ``y_rows``."""
    win = y_rows.unfold(-1, w, 1)[:, :, :n_out, :]        # (r, C, n_out, w)
    return win.permute(0, 2, 1, 3).reshape(-1, y_rows.shape[1] * w)


def search(y: torch.Tensor, contexts: np.ndarray, kernel: np.ndarray,
           horizon: int, k: int, arith: Arith):
    """The ``k`` windows of ``y (R, C, T)`` closest to each context
    ``(B, C, w)``: distances ``(B, k)`` float64 ascending, flat ids
    ``(B, k)`` int64 (ties by lower id) and the winners' paths
    ``(B, k, C, w + horizon)`` in ``arith``'s dtype.

    The scan ranks windows by ``|E(y)|^2 - 2 <E(x), E(y)>`` in ``arith``,
    block by block of rows; the k winners are then scored directly."""
    R, C, T = y.shape
    d, _, w = kernel.shape
    n_out = T - w - horizon + 1
    dev = y.device
    K = arith.q(torch.as_tensor(kernel.reshape(d, C * w), device=dev))
    x = torch.as_tensor(np.asarray(contexts).reshape(-1, C * w), device=dev)
    B = x.shape[0]
    with exact_products():
        x_emb = arith.mm(x, K.T)                               # (B, d)
        rows = max(1, BLOCK_WINDOWS // n_out)
        best_v = torch.full((B, k), float("inf"), dtype=arith.torch_dtype,
                            device=dev)
        best_i = torch.zeros((B, k), dtype=torch.int64, device=dev)
        for r0 in range(0, R, rows):
            emb = arith.mm(_windows(y[r0 : r0 + rows], w, n_out), K.T)
            score = (arith.sumsq(emb)[:, None] - 2.0 * arith.mm(emb, x_emb.T)).T
            take = min(k, score.shape[1])
            v, i = torch.topk(score, take, dim=1, largest=False)
            v = torch.cat([best_v, v], dim=1)
            i = torch.cat([best_i, i + r0 * n_out], dim=1)
            v, j = torch.topk(v, k, dim=1, largest=False)
            best_v, best_i = v, torch.gather(i, 1, j)
        paths = gather_paths(y, best_i, n_out, w + horizon).to(arith.torch_dtype)
        emb = arith.mm(paths[..., :w].reshape(B, k, C * w), K.T)   # (B, k, d)
        dist = torch.sqrt(arith.sumsq(emb - x_emb[:, None, :])
                          / arith.sumsq(x_emb)[:, None])
    dist = dist.double().cpu().numpy()
    flat = best_i.cpu().numpy()
    order = np.lexsort((flat, dist), axis=-1)
    return (np.take_along_axis(dist, order, axis=1),
            np.take_along_axis(flat, order, axis=1),
            paths[torch.arange(B, device=dev)[:, None],
                  torch.as_tensor(order, device=dev)])


def gather_paths(y: torch.Tensor, flat: torch.Tensor, n_out: int,
                 length: int) -> torch.Tensor:
    """``y[r, :, t : t + length]`` for every flat id ``r * n_out + t``:
    ``(*flat.shape, C, length)``."""
    r, t = flat // n_out, flat % n_out
    ch = torch.arange(y.shape[1], device=y.device)
    pos = t[..., None, None] + torch.arange(length, device=y.device)
    return y[r[..., None, None], ch[:, None], pos]
