"""Exact k-smallest selection with a deterministic tie rule.

Port of :mod:`shadowing_tpu.ops.topk`. Among equal values the lower index
wins (``lax.top_k``'s rule), and :func:`merge_min` lets the earlier operand
win ties. ``torch.topk`` promises neither, so the exact selections here are
a *stable* ascending sort followed by a slice (:func:`topk_min_sort`); where
``torch.topk`` is used (the selection of blocks) it supplies only the k-th
value, and ties at it are filled in id order.

A stable sort of millions of scores per context is what dominates a search
at large k, so the fused route selects through the **block-min tournament**
(:func:`topk_min_batched`):

1. view each row as blocks and take every block's minimum (one streaming
   pass);
2. select the ``cap`` blocks with the smallest minima, through this same
   tournament when there are many blocks;
3. gather those blocks' elements, in flat order, and take the exact k
   smallest of the ``cap * block`` candidates.

The result is exact whenever the k-th candidate value is strictly below the
best minimum among the *unselected* blocks (``mu_cap``): every unselected
element is then worse than all k winners. ``ok`` certifies this per row;
callers check it once on the host and redo uncertified rows exactly (the
engine does), or call :func:`topk_min_checked`.

Pass 2 of the two-pass search needs no tournament and no certificate of
its own: on every device it selects exactly through :func:`select_lowest`,
the hand-written radix select of ``csrc/select_lowest.cu`` on a CUDA tensor
and its plain version :func:`_lowest_set` on a CPU tensor.

Indices are int64. The JAX module's row chunking of the candidate gather
under a byte budget is a TPU layout rule and has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from shadowing_tpu_torch.ops._build import Kernel, check_tensor, ptr
from shadowing_tpu_torch.utils.profiling import count

_DEFAULT_BLOCK = 128

SELECT = Kernel("select_lowest", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
# csrc/select_lowest.cu's constants: entries a block reads per step (a warp
# 256), warps per block, bins of a digit's histogram, state words per row,
# blocks per SM its launch bounds allow, and the longest row
_SEL_CHUNK, _SEL_WARPS, _SEL_BINS, _SEL_STATE = 2048, 8, 2048, 8
_SEL_BLOCKS_PER_SM, _SEL_MAX_N = 4, 1 << 30

#: narrow fold width for the large-k regime: candidates shrink to
#: ``8 * cap`` while the fold itself stays one streaming pass
_NARROW = 8


class TopKResult(NamedTuple):
    values: torch.Tensor   # (..., k) ascending
    indices: torch.Tensor  # (..., k) int64 indices into the last axis
    ok: torch.Tensor       # (...) bool — True iff the result is certified


class TopKBatchResult(NamedTuple):
    values: torch.Tensor   # (B, k) ascending
    indices: torch.Tensor  # (B, k) int64 flat indices into each row
    ok: torch.Tensor       # (B,) bool per-row certification


def _tournament_cap(n: int, k: int, block: int, cap: Optional[int]) -> int:
    n_blocks = -(-n // block)
    if cap is None:
        # in the worst spread every winner sits in its own block, so the
        # certified-exact region needs cap >= k blocks; 2k + slack makes the
        # certification-failure probability negligible for i.i.d.-ish scores
        # (clustered winners only reduce the number of blocks needed).
        cap = max(2 * k + 256, 512)
    cap = min(cap, n_blocks)
    if cap * block < k:
        cap = -(-k // block)
    return min(cap, n_blocks)


def topk_min_sort(scores: torch.Tensor, k: int) -> TopKResult:
    """The ``k`` smallest values along the last axis of ``scores``,
    ascending, by a full stable sort (slow, always correct): ties go to the
    lower index."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds number of scores n={scores.shape[-1]}")
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    ok = torch.ones(scores.shape[:-1], dtype=torch.bool, device=scores.device)
    return TopKResult(vals[..., :k], idx[..., :k], ok)


def topk_min(
    scores: torch.Tensor,
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: Optional[int] = None,
) -> TopKResult:
    """Exact k smallest values (and flat indices) of a 1-d score tensor.

    Returns ``ok=False`` (with best-effort values) in the rare case the
    tournament bound cannot certify exactness; callers must then fall back
    to :func:`topk_min_sort`. This is row 0 of :func:`topk_min_batched` on
    a singleton batch."""
    values, indices, ok = topk_min_batched(scores[None], k, block, cap)
    return TopKResult(values[0], indices[0], ok[0])


def _lowest_set(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ids ``(B, k)``, ascending, of the k smallest entries of each row
    of ``x (B, n)`` (lower id first among equal values), and the k-th
    smallest value ``(B,)``.

    ``torch.topk`` only supplies the threshold, which does not depend on its
    tie order: everything below it is in, and the entries equal to it fill
    the rest in id order. No host read. Scores must not be NaN."""
    B, n = x.shape
    thr = torch.topk(x, k, dim=1, largest=False, sorted=False).values.amax(
        dim=1, keepdim=True)
    below = x < thr
    at = x == thr
    need = k - below.sum(dim=1, keepdim=True)
    take = below | (at & (at.cumsum(dim=1) <= need))
    # the j-th taken entry of a row lands in column j; the others in a spare
    slot = torch.where(take, take.cumsum(dim=1) - 1, k)
    ids = torch.empty((B, k + 1), dtype=torch.int64, device=x.device)
    ids.scatter_(1, slot, torch.arange(n, device=x.device).expand(B, n))
    return ids[:, :k], thr[:, 0]


def select_tiles(B: int, n: int, sms: int) -> int:
    """Tiles per row of :func:`select_lowest`'s grid: whole chunks each, and
    about one wave of blocks over ``sms`` SMs, whether B is 1 or 64."""
    chunks = -(-n // _SEL_CHUNK)
    tiles = max(1, min(chunks, _SEL_BLOCKS_PER_SM * sms // B))
    per_tile = -(-chunks // tiles)
    return -(-chunks // per_tile)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def select_lowest(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ids ``(B, k)`` int64, ascending, of the k smallest entries of each
    row of ``x (B, n)`` under the order (value, id), and the k-th smallest
    value ``(B,)``. ``-0.0`` equals ``0.0``; ``+inf`` is allowed, NaN is
    not.

    On a CUDA tensor it launches ``csrc/select_lowest.cu`` (counter
    ``select_kernel_rows``); on a CPU tensor it runs the plain
    :func:`_lowest_set`. There is no fallback between the two."""
    check_tensor(x, "x", 2, x.device)
    B, n = x.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of scores n={n}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if x.device.type == "cpu":
        return _lowest_set(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"no select_lowest kernel for device {x.device}")
    if n > _SEL_MAX_N:
        raise ValueError(f"n={n} exceeds the kernel's {_SEL_MAX_N} entries")
    tiles = select_tiles(B, n, _sm_count(x.device))
    ids = torch.empty((B, k), dtype=torch.int64, device=x.device)
    thr = torch.empty((B,), dtype=torch.float32, device=x.device)
    scratch = torch.empty(
        B * (_SEL_BINS + _SEL_STATE + 3 * _SEL_WARPS * tiles + 2 * n),
        dtype=torch.int32, device=x.device)
    SELECT.launch(ptr(x), ptr(ids), ptr(thr), ptr(scratch), B, n, k, tiles)
    count("select_kernel_rows", B)
    return ids, thr


def topk_min_batched(
    scores: torch.Tensor,  # (B, N)
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: Optional[int] = None,
) -> TopKBatchResult:
    """Row-wise certified k smallest of a 2-d score tensor (counter
    ``select_tournament_rows``).

    The tournament is **adaptive**: at large k the ``cap * block``
    candidates of a 128-wide fold approach n and the tournament would
    degenerate into a full gather and a full sort. So (a) when ``cap *
    block`` is not a small fraction of n the fold narrows to
    ``_NARROW``-wide blocks, shrinking the candidates to ``8 * cap``; and
    (b) the selection of the ``cap`` block minima recurses through this same
    tournament when the minima are themselves many. Where even that cannot
    shrink the problem the stable sort answers, certified by construction.
    """
    count("select_tournament_rows", scores.shape[0])
    return _tournament(scores, k, block, cap)


def _tournament(scores: torch.Tensor, k: int, block: int,
                cap: Optional[int]) -> TopKBatchResult:
    B, n = scores.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of scores n={n}")
    if n <= 4 * k or n <= 2 * block:
        return TopKBatchResult(*topk_min_sort(scores, k))

    # large-k regime: narrow the fold so candidates stay a small fraction
    # of n (cap is a block COUNT — the certification worst case of k
    # winners in k distinct blocks is width-independent, so the same count
    # stays valid at the narrower width). Width is decided on the
    # *unclamped* cap, then the count is clamped for the chosen width.
    cap0 = cap if cap is not None else max(2 * k + 256, 512)
    if cap0 * block * 4 > n and block > _NARROW:
        block = _NARROW
    cap = _tournament_cap(n, k, block, cap)
    if cap * block * 2 >= n:
        # even the narrow fold cannot shrink the problem: sort-exact
        return TopKBatchResult(*topk_min_sort(scores, k))
    n_blocks = -(-n // block)   # cap <= n_blocks (clamped in _tournament_cap)
    pad = n_blocks * block - n
    if pad:
        scores = torch.cat(
            [scores, scores.new_full((B, pad), float("inf"))], dim=1)
    blocks = scores.reshape(B, n_blocks, block)
    bmin = blocks.amin(dim=2)                                # (B, G)

    # cap smallest block minima, ids in flat order (the candidate order
    # fixes the tie rule) — recurse through the tournament when G is itself
    # large (the recursion bottoms out in the sort-exact paths)
    if n_blocks > 4 * cap:
        mu_sel, bidx, sel_ok = _tournament(bmin, cap, _NARROW, cap + 256)
        mu_cap = mu_sel[:, -1]
        bidx = torch.sort(bidx, dim=1).values
    else:
        bidx, mu_cap = _lowest_set(bmin, cap)
        sel_ok = torch.ones((B,), dtype=torch.bool, device=scores.device)

    cand = torch.gather(blocks, 1, bidx[..., None].expand(B, cap, block))
    cand_idx = bidx[..., None] * block + torch.arange(block,
                                                      device=scores.device)
    values, local, _ = topk_min_sort(cand.reshape(B, cap * block), k)
    indices = torch.gather(cand_idx.reshape(B, cap * block), 1, local)
    # cap < n_blocks here, so there is an unselected block to certify against
    return TopKBatchResult(values, indices, sel_ok & (values[:, -1] < mu_cap))


def topk_min_checked(
    scores: torch.Tensor,
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: Optional[int] = None,
) -> TopKResult:
    """Exact k smallest of a 1-d score tensor with the sort fallback folded
    in: one host read of ``ok`` decides it."""
    n = scores.shape[0]
    if n <= 4 * k or n <= 2 * block:
        return topk_min_sort(scores, k)
    fast = topk_min(scores, k, block, cap)
    return fast if bool(fast.ok) else topk_min_sort(scores, k)


def merge_min(
    values_a: torch.Tensor,
    indices_a: torch.Tensor,
    values_b: torch.Tensor,
    indices_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact merge of two k-smallest partial results along the last axis;
    on equal values the earlier operand (``a``) wins."""
    v = torch.cat([values_a, values_b], dim=-1)
    i = torch.cat([indices_a, indices_b], dim=-1)
    vals, sel, _ = topk_min_sort(v, k)
    return vals, torch.gather(i, -1, sel)
