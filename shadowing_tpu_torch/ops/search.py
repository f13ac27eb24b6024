"""Two-pass exact search: pass-1 block minima (kernel 1), pass-2 rescore.

Port of :mod:`shadowing_tpu.ops.pallas_search`.

* **Pass 1** (:func:`score_blockmin`): for every context, trajectory row and
  block of ``L = 128`` window starts, the minimum of the expansion score
  ``norms - 2 * cross``. On a CUDA tensor it launches the hand-written
  kernel ``csrc/blockmin_toeplitz.cu`` (fp32 FMAs in tap order,
  register-tiled; held to the plain version within 1e-5 of max|score|, as
  cuDNN's summation order is not fixed); on a CPU tensor it runs the plain
  PyTorch version (``conv1d`` plus the min-fold). There is no fallback
  between the two.
* **Pass 2** (:func:`pass2_from_bmin`): select the ``cap`` best blocks per
  context, rescore their windows exactly in fp32 from the raw data, take the
  exact k smallest (lower flat id first on ties) and certify the result
  against the best unselected block with a self-calibrated guard band. Both
  selections go through the certified tournament of
  :mod:`shadowing_tpu_torch.ops.topk`, whose flags join pass 2's own.

Flat ids are ``traj * n_out + t`` in int64; blocks use the r-major id
``r * nblk + j`` for both pass-1 kernels.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from shadowing_tpu_torch.ops._build import Kernel, ptr
from shadowing_tpu_torch.ops.sliding import sliding_dot
from shadowing_tpu_torch.ops.topk import topk_min_batched

L = 128                   # window starts per block
MAX_WIDTH = 3 * L + 1     # widest filter the engine routes to the kernels (385)
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on an H100
_SMEM_HALF = 113 * 1024   # ... and each of two blocks on one SM
_SCRATCH = 256 << 20      # bytes of temporaries per chunk of the plain paths
# the kernel's constants (csrc/blockmin_toeplitz.cu): starts per thread,
# starts per tile, tiles in flight
_P, _NST, _STAGES = 8, 256 * 8, 3

TOEPLITZ = Kernel("blockmin_toeplitz", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 8)


def n_blocks(n_out: int) -> int:
    return -(-n_out // L)


def check_tensor(t: torch.Tensor, name: str, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of rank ``ndim``
    on ``device`` — what the kernels' raw pointers assume."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {ndim}-d tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _fold_min(s: torch.Tensor, n_out: int) -> torch.Tensor:
    """``(..., n_out)`` scores -> ``(..., nblk)`` block minima, +inf padded."""
    nblk = n_blocks(n_out)
    s = F.pad(s, (0, nblk * L - n_out), value=float("inf"))
    return s.unflatten(-1, (nblk, L)).amin(-1)


@dataclass(frozen=True)
class ToeplitzPlan:
    """The launch plan of kernel 1, mirrored by ``make_plan`` in
    ``csrc/blockmin_toeplitz.cu`` (which refuses a launch whose shared
    memory differs): taps padded to ``wp``, ``seg`` samples per channel and
    tile (``_NST`` starts plus the halo), ``cg`` channels per slot of the
    ring of ``_STAGES`` slots, ``tiles`` (row, 2,048-start) tiles, and the
    context chunks, one launch each.

    Where all ``C`` channels of a tile fit the ring beside one context's
    filter, ``cg = C`` and a chunk holds as many filters as fit beside it.
    Otherwise the channels go through the ring in groups of ``cg``, each
    slot with its group's taps of a context pair, sized for two blocks per
    SM, and a chunk holds at most two contexts."""

    wp: int
    seg: int
    cg: int
    tiles: int
    chunks: Tuple[Tuple[int, int], ...]   # (first context, contexts)
    smem_bytes: Tuple[int, ...]           # per launch


def toeplitz_plan(R: int, C: int, w: int, n_out: int, B: int) -> ToeplitzPlan:
    """Taps, channel groups, tiles, context chunks and shared memory of one
    call."""
    wp = -(-w // _P) * _P
    seg = _NST + wp
    fixed = 4 * _STAGES * (C * seg + _NST)
    per_ctx = 4 * C * wp
    bc = (_SMEM_LIMIT - fixed) // per_ctx
    if bc >= 1:
        cg = C
        smem = lambda nb: fixed + nb * per_ctx
    else:
        most = max((_SMEM_HALF // 4 // _STAGES - _NST) // (seg + 2 * wp), 1)
        groups = -(-C // most)
        cg, bc = -(-C // groups), 2
        smem = lambda nb: 4 * _STAGES * (cg * (seg + 2 * wp) + _NST)
    chunks = tuple((b0, min(bc, B - b0)) for b0 in range(0, B, bc))
    smem_bytes = tuple(smem(nb) for _, nb in chunks)
    if max(smem_bytes) > _SMEM_LIMIT:
        raise ValueError(f"w={w}: the staged samples exceed the kernel's "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    return ToeplitzPlan(wp, seg, cg, R * -(-n_blocks(n_out) * L // _NST),
                        chunks, smem_bytes)


def score_blockmin_plain(y: torch.Tensor, norms: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pass 1: ``conv1d`` cross terms plus the min-fold,
    streamed over row chunks. Returns ``(B, R, nblk)``."""
    R, _, _ = y.shape
    B = g.shape[0]
    n_out = norms.shape[1]
    out = torch.empty((B, R, n_blocks(n_out)), dtype=torch.float32,
                      device=y.device)
    rows = max(1, _SCRATCH // (8 * B * n_blocks(n_out) * L))
    for r0 in range(0, R, rows):
        cross = sliding_dot(y[r0 : r0 + rows], g, n_out)        # (r, B, n_out)
        s = norms[r0 : r0 + rows, None, :] - 2.0 * cross
        out[:, r0 : r0 + rows] = _fold_min(s, n_out).transpose(0, 1)
    return out


def score_blockmin(y: torch.Tensor, norms: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Pass-1 block minima ``(B, R, nblk)`` of ``norms - 2 * (y ⋆ g_b)``.

    :param y: ``(R, C, T)`` trajectories
    :param norms: ``(R, n_out)`` window norms (``+inf`` bars a row)
    :param g: ``(B, C, w)`` combined context filters
    """
    check_tensor(y, "y", 3, y.device)
    check_tensor(norms, "norms", 2, y.device)
    check_tensor(g, "g", 3, y.device)
    R, C, T = y.shape
    B, Cg, w = g.shape
    n_out = norms.shape[1]
    if Cg != C or norms.shape[0] != R or n_out > T - w + 1:
        raise ValueError(f"shape mismatch: y {tuple(y.shape)}, norms "
                         f"{tuple(norms.shape)}, g {tuple(g.shape)}")
    if y.device.type == "cpu":
        return score_blockmin_plain(y, norms, g)
    if y.device.type != "cuda":
        raise ValueError(f"no blockmin_toeplitz kernel for device {y.device}")
    nblk = n_blocks(n_out)
    plan = toeplitz_plan(R, C, w, n_out, B)
    if plan.tiles >= 2**31:
        raise ValueError(f"R={R} rows exceed the kernel's tile count")
    out = torch.empty((B, R, nblk), dtype=torch.float32, device=y.device)
    for (b0, nb), smem in zip(plan.chunks, plan.smem_bytes):
        TOEPLITZ.launch(ptr(y), ptr(norms), ptr(g[b0 : b0 + nb]),
                        ptr(out[b0 : b0 + nb]), R, C, T, n_out, nblk, nb, w,
                        smem)
    return out


def _candidate_cross(y: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                     j: torch.Tensor) -> torch.Tensor:
    """Exact fp32 cross terms ``(B, cap, L)`` of every window start of the
    selected blocks ``(r, j)``, accumulated tap by tap (channel-major, as the
    kernel does): every window is summed in the same order wherever it
    sits, so equal windows score bit-equal and ties stay ties."""
    B, C, w = g.shape
    T = y.shape[2]
    ch = torch.arange(C, device=y.device)
    # valid starts never read past T; clamping only feeds padded starts,
    # whose scores pass 2 discards
    pos = (j[..., None] * L + torch.arange(L + w - 1, device=y.device)
           ).clamp_(max=T - 1)                                    # (B, cap, S)
    seg = y[r[..., None, None], ch[:, None], pos[:, :, None, :]]  # (B, cap, C, S)
    acc = torch.zeros((B, r.shape[1], L), dtype=torch.float32, device=y.device)
    for c in range(C):
        for s in range(w):
            acc.addcmul_(seg[:, :, c, s : s + L], g[:, c, s, None, None])
    return acc


def pass2_from_bmin(
    bmin: torch.Tensor,     # (B, R, nblk) block minima, r-major
    y: torch.Tensor,        # (R, C, T)
    norms: torch.Tensor,    # (R, n_out)
    g: torch.Tensor,        # (B, C, w)
    k: int,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global block selection, exact rescore, certified final top-k.

    Returns scores ``(B, k)`` ascending, int64 flat ids ``traj * n_out + t``
    and per-context certification flags ``ok (B,)``."""
    B, R, nblk = bmin.shape
    n_out = norms.shape[1]
    nb = R * nblk
    if cap is None:
        # at most k - 1 blocks can hold a value strictly below the k-th
        # winner, so k + slack blocks select every block that could matter
        cap = min(max(k + 384, 512), nb)
    cap = min(max(cap, -(-k // L)), nb)

    # cap best blocks per context — the tournament instead of a flat top-k
    # or sort over millions of block minima
    mu_sel, bidx, sel_ok = topk_min_batched(bmin.reshape(B, nb), cap, block=L,
                                            cap=cap + 128)
    inf = torch.tensor(float("inf"), device=bmin.device)
    mu_cap = mu_sel[:, -1] if cap < nb else inf.expand(B)
    # blocks to flat order (the candidate order fixes the tie rule), carrying
    # the pass-1 minima along to calibrate the guard below
    bidx, perm = torch.sort(bidx, dim=1)
    mu_sorted = torch.gather(mu_sel, 1, perm)
    r = bidx // nblk
    j = bidx % nblk

    cross = _candidate_cross(y, g, r, j)                          # (B, cap, L)
    t = j[..., None] * L + torch.arange(L, device=y.device)       # (B, cap, L)
    valid = t < n_out
    nsel = norms[r[..., None], t.clamp(max=n_out - 1)]
    # padded starts and barred rows become a huge finite loser, so the
    # arithmetic below stays NaN-free
    nsel = torch.where(valid & torch.isfinite(nsel), nsel,
                       torch.tensor(1e30, device=y.device))
    s = nsel - 2.0 * cross
    flat = r[..., None] * n_out + t                               # (B, cap, L)
    # final exact selection — the tournament again; the k winners occupy at
    # most k of the cap candidate blocks, so a tight cap is certified-safe
    vals, loc, fin_ok = topk_min_batched(s.reshape(B, cap * L), k, block=L,
                                         cap=k + 128)
    idx = torch.gather(flat.reshape(B, cap * L), 1, loc)

    # self-calibrated guard: the selected blocks' |pass-1 min - exact min|
    # samples the pass-1 error of the unselected ones; 2x its per-context
    # max plus the 1e-5 floor bounds it
    exact_bmin = s.amin(dim=2)
    err_obs = torch.where(torch.isfinite(mu_sorted) & (exact_bmin < 1e29),
                          (mu_sorted - exact_bmin).abs(),
                          torch.zeros_like(exact_bmin)).amax(dim=1)
    guard = 2.0 * err_obs + 1e-5 * mu_cap.abs() + 1e-12
    ok = torch.isinf(mu_cap) | (vals[:, -1] + guard < mu_cap)
    return vals, idx, ok & sel_ok & fin_ok


def two_pass_search(
    y: torch.Tensor,
    norms: torch.Tensor,
    g: torch.Tensor,
    k: int,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact k-smallest scores over all (trajectory, window start) pairs
    through kernel 1; same return contract as :func:`pass2_from_bmin`."""
    if g.shape[-1] > MAX_WIDTH:
        raise ValueError(f"filter width {g.shape[-1]} > {MAX_WIDTH}")
    return pass2_from_bmin(score_blockmin(y, norms, g), y, norms, g, k, cap)
