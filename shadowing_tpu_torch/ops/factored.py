"""Context-factored pass 1 (kernel 2): precomputed embedding responses.

Port of :mod:`shadowing_tpu.ops.pallas_factored`. The combined context
filter is linear in the embedding, ``g_b = sum_d x_emb[b, d] * kernel_d``,
so the cross term of every context is ``x_emb[b] . E[r, :, t]`` with the
context-independent responses ``E[r, d, t] = (y ⋆ kernel_d)[r, t]``. ``E`` is
built once per engine (:func:`build_factored`, fp32 ``conv1d``); each search
then reduces pass 1 to a ``(B, d)``-by-``E`` contraction with the block-min
folded in (:func:`score_blockmin_factored`): the hand-written kernel
``csrc/blockmin_factored.cu`` on a CUDA tensor, the plain PyTorch version
(``matmul`` plus the min-fold) on a CPU tensor. Block minima come out in the
r-major layout of :func:`~shadowing_tpu_torch.ops.search.score_blockmin`, so
pass 2 is shared unchanged.

``E`` is float32 ``(R, d, nblk * L)``, window start innermost, zero past
``n_out``: ``R * d * nblk * 128 * 4`` bytes (:func:`e_bytes`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from shadowing_tpu_torch.array_types import fp32_exact
from shadowing_tpu_torch.ops._build import Kernel, ptr
from shadowing_tpu_torch.ops.search import (
    L,
    _SCRATCH,
    _fold_min,
    check_tensor,
    n_blocks,
    pass2_from_bmin,
)
from shadowing_tpu_torch.ops.sliding import sliding_dot

#: widest embedding the kernel holds in registers
MAX_DIM = 48
#: contexts per kernel launch (the launch stages them in shared memory)
_B_KERNEL = 128

FACTORED = Kernel("blockmin_factored", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 6)


def e_bytes(R: int, n_out: int, d: int) -> int:
    """Device bytes of the factored responses ``E``."""
    return R * d * n_blocks(n_out) * L * 4


def build_factored(y: torch.Tensor, kernel: torch.Tensor,
                   n_out: int) -> torch.Tensor:
    """``E (R, d, nblk * L)`` of the plan kernel ``(d, C, w)`` over ``y``,
    built in row chunks straight into its final buffer."""
    R, _, T = y.shape
    d = kernel.shape[0]
    Tp = n_blocks(n_out) * L
    E = torch.empty((R, d, Tp), dtype=torch.float32, device=y.device)
    E[:, :, n_out:] = 0.0
    rows = max(1, (4 * _SCRATCH) // (4 * d * T))
    for r0 in range(0, R, rows):
        E[r0 : r0 + rows, :, :n_out] = sliding_dot(y[r0 : r0 + rows], kernel,
                                                   n_out)
    return E


def score_blockmin_factored_plain(E: torch.Tensor, norms: torch.Tensor,
                                  x_emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel 2: fp32 ``matmul`` plus the min-fold, streamed
    over row chunks. Returns ``(B, R, nblk)``."""
    R, _, Tp = E.shape
    B = x_emb.shape[0]
    n_out = norms.shape[1]
    out = torch.empty((B, R, n_blocks(n_out)), dtype=torch.float32,
                      device=E.device)
    rows = max(1, _SCRATCH // (8 * B * Tp))
    with fp32_exact():
        for r0 in range(0, R, rows):
            cross = torch.matmul(x_emb, E[r0 : r0 + rows, :, :n_out])  # (r, B, n_out)
            s = norms[r0 : r0 + rows, None, :] - 2.0 * cross
            out[:, r0 : r0 + rows] = _fold_min(s, n_out).transpose(0, 1)
    return out


def score_blockmin_factored(E: torch.Tensor, norms: torch.Tensor,
                            x_emb: torch.Tensor) -> torch.Tensor:
    """Pass-1 block minima ``(B, R, nblk)`` of ``norms - 2 * x_emb[b] . E``.

    :param E: ``(R, d, nblk * L)`` from :func:`build_factored`
    :param norms: ``(R, n_out)`` window norms (``+inf`` bars a row)
    :param x_emb: ``(B, d)`` context embeddings
    """
    dev = E.device
    check_tensor(E, "E", 3, dev)
    check_tensor(norms, "norms", 2, dev)
    check_tensor(x_emb, "x_emb", 2, dev)
    R, d, Tp = E.shape
    B = x_emb.shape[0]
    n_out = norms.shape[1]
    nblk = n_blocks(n_out)
    if x_emb.shape[1] != d or norms.shape[0] != R or Tp != nblk * L:
        raise ValueError(f"shape mismatch: E {tuple(E.shape)}, norms "
                         f"{tuple(norms.shape)}, x_emb {tuple(x_emb.shape)}")
    if dev.type == "cpu":
        return score_blockmin_factored_plain(E, norms, x_emb)
    if dev.type != "cuda":
        raise ValueError(f"no blockmin_factored kernel for device {dev}")
    if d > MAX_DIM:
        raise ValueError(f"embedding dim {d} > MAX_DIM={MAX_DIM}")
    if R * nblk >= 2**31:
        raise ValueError(f"R={R} rows exceed the kernel's grid")
    out = torch.empty((B, R, nblk), dtype=torch.float32, device=dev)
    for b0 in range(0, B, _B_KERNEL):
        xc = x_emb[b0 : b0 + _B_KERNEL]
        nb = xc.shape[0]
        FACTORED.launch(ptr(E), ptr(norms), ptr(xc), ptr(out[b0 : b0 + nb]),
                        R, d, Tp, n_out, nblk, nb)
    return out


def two_pass_search_factored(
    E: torch.Tensor,
    norms: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,        # (B, C, w) combined filters (pass-2 rescore)
    x_emb: torch.Tensor,    # (B, d) context embeddings (pass 1)
    k: int,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel-2 twin of :func:`~shadowing_tpu_torch.ops.search.two_pass_search`
    (same return contract)."""
    return pass2_from_bmin(score_blockmin_factored(E, norms, x_emb),
                           y, norms, g, k, cap)
