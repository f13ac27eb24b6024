"""Context-factored pass 1 (kernel 2): precomputed embedding responses.

Port of :mod:`shadowing_tpu.ops.pallas_factored`. The combined context
filter is linear in the embedding, ``g_b = sum_d x_emb[b, d] * kernel_d``,
so the cross term of every context is ``x_emb[b] . E[r, :, t]`` with the
context-independent responses ``E[r, d, t] = (y ⋆ kernel_d)[r, t]``. ``E`` is
built once per engine (:func:`build_factored`, fp32 ``conv1d``); each search
then reduces pass 1 to a ``(B, d)``-by-``E`` contraction with the block-min
folded in (:func:`score_blockmin_factored`): the hand-written kernel
``csrc/blockmin_factored.cu`` on a CUDA tensor (wgmma on the tensor cores in
3xTF32, within ~2^-21 of fp32 per product, so not bit-equal to the plain
version), the plain PyTorch version (``matmul`` plus the min-fold) on a CPU
tensor. Block minima come out in the r-major layout of
:func:`~shadowing_tpu_torch.ops.search.score_blockmin`, so pass 2 is shared
unchanged.

``E`` is float32 ``(R, d, nblk * L)``, window start innermost, zero past
``n_out``: ``R * d * nblk * 128 * 4`` bytes (:func:`e_bytes`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
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
from shadowing_tpu_torch.utils.profiling import span

#: widest embedding the kernel takes
MAX_DIM = 48
#: contexts per kernel launch (the launch stages them in shared memory)
_B_KERNEL = 128
# the kernel's constants (csrc/blockmin_factored.cu)
_STAGES, _EST, _WARPS = 3, L + 8, 4

FACTORED = Kernel("blockmin_factored", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 7)


@dataclass(frozen=True)
class FactoredPlan:
    """The launch plan of kernel 2, mirrored by ``make_plan`` in
    ``csrc/blockmin_factored.cu`` (which refuses a launch whose shared
    memory differs). ``d`` is zero-padded to ``k8`` 8-deep TF32 MMA steps;
    each launch takes one context chunk in passes of 64 contexts, a last
    pass 8, 16, 32 or 64 wide; the persistent blocks walk ``tiles`` (row,
    128-start block) tiles through a ring of ``_STAGES``."""

    k8: int
    chunks: Tuple[Tuple[int, int], ...]   # (first context, contexts) per launch
    passes: Tuple[Tuple[int, int], ...]   # (64-wide passes, last pass's n-tiles)
    smem_bytes: Tuple[int, ...]           # per launch
    tiles: int


def factored_plan(R: int, d: int, n_out: int, B: int) -> FactoredPlan:
    """Tiles, padded K, context chunks and shared memory of one call."""
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"embedding dim {d} outside 1..MAX_DIM={MAX_DIM}")
    k8 = -(-d // 8)
    chunks, passes, smem = [], [], []
    for b0 in range(0, B, _B_KERNEL):
        nb = min(_B_KERNEL, B - b0)
        nt = -(-nb // 8)
        tail = nt % 8
        tail_nt = 0 if tail == 0 else 1 << (tail - 1).bit_length()
        bp = 8 * (8 * (nt // 8) + tail_nt)
        rows = 8 * k8
        floats = (2 * bp * rows + _STAGES * rows * _EST + _STAGES * L
                  + 2 * _WARPS * bp)
        chunks.append((b0, nb))
        passes.append((nt // 8, tail_nt))
        smem.append(4 * floats)
    return FactoredPlan(k8, tuple(chunks), tuple(passes), tuple(smem),
                        R * n_blocks(n_out))


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
    with span("psmc.pass1"):
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
                             f"{tuple(norms.shape)}, x_emb "
                             f"{tuple(x_emb.shape)}")
        if dev.type == "cpu":
            return score_blockmin_factored_plain(E, norms, x_emb)
        if dev.type != "cuda":
            raise ValueError(
                f"no blockmin_factored kernel for device {dev}")
        plan = factored_plan(R, d, n_out, B)
        if plan.tiles >= 2**31:
            raise ValueError(f"R={R} rows exceed the kernel's tile count")
        out = torch.empty((B, R, nblk), dtype=torch.float32, device=dev)
        for (b0, nb), smem in zip(plan.chunks, plan.smem_bytes):
            FACTORED.launch(ptr(E), ptr(norms), ptr(x_emb[b0 : b0 + nb]),
                            ptr(out[b0 : b0 + nb]), R, d, Tp, n_out, nblk, nb,
                            smem)
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
