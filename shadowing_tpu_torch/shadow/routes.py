"""The single-device search steps, which know no mesh and no engine state.

Window norms, the context's embedding and combined filters, the literal
``"direct"`` oracle, the fused route's chunk loop, the extraction of the
winners' windows, the positions of a window's input samples and the
winners' exact rescore. The mesh
(:mod:`shadowing_tpu_torch.parallel.sharding`) runs them on each rank's
shard; the engine (:mod:`shadowing_tpu_torch.shadow.engine`) prepares
its contexts here and reaches the rest through the mesh, a mesh of one
without one. Nothing here imports either.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from shadowing_tpu_torch.array_types import fp32_exact
from shadowing_tpu_torch.ops.finalize import embed_windows
from shadowing_tpu_torch.ops.sliding import sliding_dot
from shadowing_tpu_torch.ops.topk import (
    merge_min,
    topk_min_batched,
    topk_min_sort,
)
from shadowing_tpu_torch.shadow.distance import PathDistance
from shadowing_tpu_torch.utils.profiling import span


# --------------------------------------------------------------------------
# window norms ‖h(y_t)‖² — context-independent, cached per engine
# --------------------------------------------------------------------------

def _window_norms(y: torch.Tensor, kernel: torch.Tensor, n_out: int,
                  n_splits: int, identity_fast: bool) -> torch.Tensor:
    """``(R, n_out)`` squared embedding norms of every window, in
    ``n_splits`` row chunks."""
    R = y.shape[0]
    chunk = -(-R // n_splits)
    out = torch.empty((R, n_out), dtype=torch.float32, device=y.device)
    if identity_fast:
        # exact when every kernel row has at most one nonzero tap: then
        # ||E||^2 = sum_tau (sum_d k[d,c,tau]^2) y[tau]^2 — one sliding dot
        # of y^2 with the squared-tap filter instead of a d-channel pass
        k2 = (kernel ** 2).sum(dim=0, keepdim=True)
    for r0 in range(0, R, chunk):
        y_c = y[r0 : r0 + chunk]
        if identity_fast:
            out[r0 : r0 + chunk] = sliding_dot(y_c * y_c, k2, n_out)[:, 0]
        else:
            e = sliding_dot(y_c, kernel, n_out)               # (r, d, n_out)
            out[r0 : r0 + chunk] = (e * e).sum(dim=1)
    return out


# --------------------------------------------------------------------------
# the literal oracle
# --------------------------------------------------------------------------

def _direct_search(y: torch.Tensor, x_emb: torch.Tensor, kernel: torch.Tensor,
                   k: int, n_out: int, n_splits: int, distance: PathDistance,
                   n_valid_rows: Optional[int] = None):
    """Embed every window, broadcast the distance, sort-exact top-k per row
    chunk, exact running merge (the reference algorithm). Rows at or past
    ``n_valid_rows`` (default: none) score ``+inf``. Returns the distances
    and int64 flat ids ``(B, k)``, ``traj * n_out + t``."""
    R = y.shape[0]
    B = x_emb.shape[0]
    chunk = -(-R // n_splits)
    valid = R if n_valid_rows is None else n_valid_rows
    d_run = torch.full((B, k), float("inf"), device=y.device)
    i_run = torch.full((B, k), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=y.device)
    for r0 in range(0, R, chunk):
        e = sliding_dot(y[r0 : r0 + chunk], kernel, n_out)   # (r, d, T')
        d = distance.forward(x_emb[:, None, None, :],
                             e.transpose(1, 2)[None])        # (B, r, T')
        d[:, max(valid - r0, 0):] = float("inf")
        vals, idx, _ = topk_min_sort(d.reshape(B, -1), min(k, d[0].numel()))
        d_run, i_run = merge_min(d_run, i_run, vals, idx + r0 * n_out, k)
    return d_run, i_run


# --------------------------------------------------------------------------
# fused search: combined-filter cross term + exact top-k, row chunks
# --------------------------------------------------------------------------

def _fused_search(y: torch.Tensor, norms: torch.Tensor, g: torch.Tensor,
                  x_norm2: torch.Tensor, k: int, n_out: int, n_splits: int,
                  distance: PathDistance, cap: Optional[int] = None):
    """Cross terms ``y ⋆ g_b`` of a row chunk (fp32 ``conv1d``), the
    distance's selection score, the chunk's k smallest through the certified
    tournament (lower flat id first on ties; ``cap`` forces its block count)
    and an exact running merge. Rows are never padded: the last chunk is
    just shorter. A row whose norms are ``+inf`` scores ``+inf``, whatever
    the distance. Returns the scores and int64 flat ids ``(B, k)`` and the
    flags ``ok (B,)``, true where every chunk's selection was certified."""
    R = y.shape[0]
    B = g.shape[0]
    chunk = -(-R // n_splits)
    d_run = torch.full((B, k), float("inf"), device=y.device)
    i_run = torch.full((B, k), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=y.device)
    ok_run = torch.ones((B,), dtype=torch.bool, device=y.device)
    for r0 in range(0, R, chunk):
        n_c = norms[None, r0 : r0 + chunk]
        cross = sliding_dot(y[r0 : r0 + chunk], g, n_out).transpose(0, 1)
        s = distance.score(x_norm2[:, None, None], cross, n_c)
        s = torch.where(torch.isinf(n_c), float("inf"), s).reshape(B, -1)
        vals, idx, ok = topk_min_batched(s, min(k, s.shape[1]), cap=cap)
        d_run, i_run = merge_min(d_run, i_run, vals, idx + r0 * n_out, k)
        ok_run = ok_run & ok
    return d_run, i_run, ok_run


def _prep_context(x_context: torch.Tensor, raw_kernel: torch.Tensor,
                  plan_kernel: torch.Tensor):
    """Context embeddings ``(B, d)``, their squared norms ``(B,)`` and the
    combined filters ``g (B, C, w')`` over the context-adjusted plan kernel.
    The context embeds with the same reduction as the rescored winners, so
    a window equal to the context rescores to exactly 0.0."""
    with span("psmc.prep"):
        x_emb = embed_windows(x_context, raw_kernel)
        x_norm2 = (x_emb * x_emb).sum(dim=-1)
        with fp32_exact():
            g = torch.einsum("bd,dcw->bcw", x_emb, plan_kernel)
    return x_emb, x_norm2, g


# --------------------------------------------------------------------------
# extraction + exact rescore
# --------------------------------------------------------------------------

def _extract_paths(y: torch.Tensor, flat_idx: torch.Tensor, n_out: int,
                   w_extract: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dataset windows ``(B, k, C, w_extract)`` at the flat ids, and the
    ``(trajectory, start)`` pairs ``(B, k, 2)``, by advanced indexing as the
    JAX package extracts them: the reference that the tests hold
    :func:`~shadowing_tpu_torch.ops.finalize.extract_windows` to. Finalize
    itself extracts through ``extract_windows``."""
    C = y.shape[1]
    traj = flat_idx // n_out
    t0 = flat_idx % n_out
    ch = torch.arange(C, device=y.device)[:, None]
    pos = t0[..., None, None] + torch.arange(w_extract, device=y.device)
    paths = y[traj[..., None, None], ch, pos]
    return paths, torch.stack([traj, t0], dim=-1)


@functools.lru_cache(maxsize=64)
def _in_positions(select_in, C: int, w_extract: int,
                  device) -> torch.Tensor:
    """int64 positions ``(w,)`` of the input samples inside an extracted
    window: ``select_in`` of the positions themselves. They carry a channel
    axis of ``C`` rows, so a context that selects channels keeps its first
    rows and one that selects samples (a horizon, a portion) keeps its
    positions. Kept per (context, C, w_extract, device), since every
    finalize asks again; callers only read the tensor."""
    pos = torch.arange(w_extract, device=device).expand(C, w_extract)
    return select_in(pos)[0].contiguous()


def _exact_rescore(x_emb: torch.Tensor, in_paths: torch.Tensor,
                   kernel: torch.Tensor, distance: PathDistance) -> torch.Tensor:
    return distance.forward(x_emb[:, None, :], embed_windows(in_paths, kernel))
