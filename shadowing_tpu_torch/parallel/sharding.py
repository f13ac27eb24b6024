"""The mesh: row-sharded search and data-parallel synthesis over ranks.

Port of :mod:`shadowing_tpu.parallel.sharding` on ``torch.distributed``,
one process per mesh position (see :mod:`.multihost` for the launch).

* **Search**: every rank holds a row shard of the dataset (R zero-padded
  to a multiple of the ``data`` axis; padding rows get ``+inf`` window
  norms, or the direct oracle's row mask, so they never win) and runs the
  single-card route on it: the two-pass search through K1 or K2, the fused
  route or the direct oracle, with ``k_loc = min(k, shard windows)``.
  Winner ids are offset to global int64 flat ids, each rank's ``(B,
  k_loc)`` values and ids cross the ranks in one ``all_gather``, and an
  exact stable k-smallest merge keeps the canonical (distance, flat id)
  order: the payload is ``B * k_loc * n * 12`` bytes, independent of R.
  Extraction gathers each winner on the rank that owns its row and sums
  the zeros of the others in one ``all_reduce``; the exact rescore and the
  sort then run on every rank alike. Results equal ``mesh=None``.
* **Synthesis**: seeds are independent optimisations, so each rank steps
  its own rows; only the scalar loss is reduced.

Every branch that leads to a collective is decided on values that are the
same on every rank (``B``, ``k``, the route, the reduced ``ok``): a rank
that entered a collective alone would wait for the group's timeout.
Over gloo, CUDA tensors cross through host copies.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from shadowing_tpu_torch.array_types import Array, dim_bct, fp32_exact
from shadowing_tpu_torch.ops import factored as factored_ops
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.ops.finalize import extract_windows, gather_embed
from shadowing_tpu_torch.ops.topk import topk_min_sort
from shadowing_tpu_torch.parallel.multihost import (
    host_row_range,
    initialize,
    rank_device,
    shard_dataset_from_local,
)
from shadowing_tpu_torch.shadow.routes import (
    _direct_search,
    _exact_rescore,
    _fused_search,
    _in_positions,
    _window_norms,
)
from shadowing_tpu_torch.utils.profiling import span

DATA_AXIS = "data"
CTX_AXIS = "ctx"


class Mesh:
    """This rank's view of a 1-d ``(data,)`` or 2-d ``(data, ctx)`` mesh:
    the axis sizes (``shape``), its position on each, the process group of
    each axis longer than 1, and its device.

    ``ranks_per_device`` counts the ranks of this host that share the card,
    so that memory budgets do not count it twice."""

    def __init__(self, shape: dict, data_pos: int, ctx_pos: int,
                 device: torch.device, groups: Optional[dict] = None,
                 ranks_per_device: int = 1):
        self.shape = dict(shape)
        self.n_data, self.n_ctx = shape[DATA_AXIS], shape.get(CTX_AXIS, 1)
        self.data_pos, self.ctx_pos = data_pos, ctx_pos
        self.device = device
        self._groups = groups or {}
        self.ranks_per_device = ranks_per_device

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, data_pos={self.data_pos}, "
                f"ctx_pos={self.ctx_pos}, device={self.device})")

    def _collective(self, t: torch.Tensor, axis: str):
        """``(group, tensor to send)``: a contiguous tensor, on the host
        when the group is gloo and ``t`` lives on a card."""
        group = self._groups[axis]
        if t.is_cuda and dist.get_backend(group) == "gloo":
            return group, t.cpu()
        return group, t.contiguous()

    def all_gather(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """``(n, *t.shape)``: every position's ``t`` along ``axis``, in
        position order."""
        if axis not in self._groups:
            return t[None]
        group, x = self._collective(t, axis)
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.stack(out).to(t.device)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """``t`` reduced over ``axis`` (a new tensor)."""
        if axis not in self._groups:
            return t.clone()
        group, x = self._collective(t, axis)
        x = x.clone() if x is t else x
        dist.all_reduce(x, op=op, group=group)
        return x.to(t.device)

    def all_true(self, flags: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """Boolean AND of ``flags`` over ``axis``."""
        return self.all_reduce(flags.to(torch.int32), dist.ReduceOp.MIN,
                               axis).bool()


def local_mesh(device) -> Mesh:
    """The mesh of one position, in this process: no collective runs."""
    return Mesh({DATA_AXIS: 1}, 0, 0, torch.device(device))


def _ranks_per_device(device: torch.device) -> int:
    if device.type != "cuda" or not dist.is_initialized():
        return 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return -(-local // torch.cuda.device_count())


def _world(device) -> Tuple[int, int]:
    """``(world size, rank)`` after :func:`~.multihost.initialize`."""
    initialize(device)
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def data_mesh(n: Optional[int] = None, *, device="cuda") -> Mesh:
    """A 1-d mesh over every rank of the world, which torchrun's
    environment forms (see :func:`~.multihost.initialize`); without one, a
    mesh of size 1 in this process.

    :param n: the mesh size; it must equal the world size
    :param device: ``"cuda"`` (this rank's card) or ``"cpu"``
    """
    world, rank = _world(device)
    if n is not None and n != world:
        raise ValueError(
            f"requested a {n}-position mesh but the world has {world} "
            f"process(es): launch one process per position with torchrun")
    dev = rank_device(device)
    groups = {DATA_AXIS: dist.group.WORLD} if world > 1 else {}
    return Mesh({DATA_AXIS: world}, rank, 0, dev, groups,
                _ranks_per_device(dev))


def data_ctx_mesh(n_data: int, n_ctx: int, *, device="cuda") -> Mesh:
    """A 2-d ``(data, ctx)`` mesh: dataset rows shard over ``data``,
    context batches over ``ctx`` (:func:`sharded_fused_search_2d`). Rank
    ``r`` sits at ``divmod(r, n_ctx)``; every rank creates every axis group,
    in the same order."""
    world, rank = _world(device)
    if n_data * n_ctx != world:
        raise ValueError(f"requested a {n_data}x{n_ctx} mesh but the world "
                         f"has {world} process(es)")
    data_pos, ctx_pos = divmod(rank, n_ctx)
    groups = {}
    if n_data > 1:
        groups[DATA_AXIS] = [
            dist.new_group([d * n_ctx + c for d in range(n_data)])
            for c in range(n_ctx)][ctx_pos]
    if n_ctx > 1:
        groups[CTX_AXIS] = [
            dist.new_group([d * n_ctx + c for c in range(n_ctx)])
            for d in range(n_data)][data_pos]
    dev = rank_device(device)
    return Mesh({DATA_AXIS: n_data, CTX_AXIS: n_ctx}, data_pos, ctx_pos, dev,
                groups, _ranks_per_device(dev))


def pad_rows_to_mesh(a: Array, mesh: Mesh) -> Array:
    """Zero-pad axis 0 to a multiple of the data axis."""
    pad = (-a.shape[0]) % mesh.n_data
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])


def shard_dataset(y: Array, mesh: Mesh) -> torch.Tensor:
    """This rank's rows ``(R_pad / n, C, T)`` of the zero-padded ``(R, C,
    T)`` dataset, float32 on its device. Only those rows are read, so a
    memory-mapped array stays on disk elsewhere."""
    y = dim_bct(y)
    R = y.shape[0]
    start, stop = host_row_range(R, mesh)
    return shard_dataset_from_local(y[start : min(stop, R)], mesh, R)


def replicate(a: Array, mesh: Mesh) -> torch.Tensor:
    """``a`` on this rank's device (every rank holds its own copy)."""
    return torch.as_tensor(a).to(mesh.device)


# --------------------------------------------------------------------------
# sharded search: the single-card routes on each shard, then one merge
# --------------------------------------------------------------------------

def _valid_rows(r_loc: int, R_true: int, mesh: Mesh) -> int:
    """Rows of this rank's shard below the global row ``R_true``."""
    return min(max(R_true - mesh.data_pos * r_loc, 0), r_loc)


def sharded_window_norms(y: torch.Tensor, kernel: torch.Tensor, n_out: int,
                         n_splits: int, identity_fast: bool, R_true: int,
                         mesh: Mesh) -> torch.Tensor:
    """``(r_loc, n_out)`` window norms of this rank's shard, ``+inf`` on
    the rows at or past the global row ``R_true``."""
    norms = _window_norms(y, kernel, n_out, n_splits, identity_fast)
    norms[_valid_rows(y.shape[0], R_true, mesh):] = float("inf")
    return norms


#: every k-merge's gathered payload per rank in bytes, keyed by the
#: gathered shape ``(n, B, k_loc)``: values float32 and ids int64, so
#: ``B * k_loc * n * 12`` whatever the dataset's size
LAST_MERGE_PAYLOAD: dict = {}


def _topk_merge(vals: torch.Tensor, idx: torch.Tensor, k: int,
                mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's ``(B, k_loc)`` candidates (ascending, global ids) in one
    ``all_gather``, then the exact k smallest. Rank order is id order and
    each rank's list is in (value, id) order, so a stable sort keeps the
    canonical tie rule: the lower flat id first."""
    if mesh.n_data == 1:
        return vals, idx
    vals_all, idx_all = mesh.all_gather(vals), mesh.all_gather(idx)
    LAST_MERGE_PAYLOAD[tuple(vals_all.shape)] = (
        vals_all.numel() * vals_all.element_size()
        + idx_all.numel() * idx_all.element_size())
    B = vals.shape[0]
    vals_all = vals_all.transpose(0, 1).reshape(B, -1)
    idx_all = idx_all.transpose(0, 1).reshape(B, -1)
    v, sel, _ = topk_min_sort(vals_all, k)
    return v, torch.gather(idx_all, 1, sel)


def _merge(vals, idx, ok, k: int, r_loc: int, n_out: int, mesh: Mesh):
    """Local ids to global ones, the k-merge, and ``ok`` AND-reduced."""
    idx = idx + mesh.data_pos * r_loc * n_out
    v, i = _topk_merge(vals, idx, k, mesh)
    return v, i, mesh.all_true(ok)


def _local_k(k: int, r_loc: int, n_out: int, n_splits: int) -> Tuple[int, int]:
    """``(k_loc, row chunks)``: at most k winners come from a shard, and
    each chunk holds at least k_loc candidates."""
    k_loc = min(k, r_loc * n_out)
    return k_loc, max(1, min(n_splits, r_loc * n_out // k_loc))


def sharded_fused_search(
    y: torch.Tensor,        # (r_loc, C, T) this rank's shard
    norms: torch.Tensor,    # (r_loc, n_out), +inf on padding rows
    g: torch.Tensor,        # (B, C, w) combined filters, the same on every rank
    x_norm2: torch.Tensor,  # (B,)
    k: int,
    n_out: int,
    distance,
    mesh: Mesh,
    n_splits: int = 1,
    cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused route (fp32 cross terms, the distance's selection score,
    the certified tournament top-k) on this rank's shard, then the k-merge.
    Returns ``(scores (B, k) ascending, global flat ids (B, k), ok (B,))``
    on every rank; ``ok`` is true where every rank certified every chunk."""
    r_loc = y.shape[0]
    k_loc, ns = _local_k(k, r_loc, n_out, n_splits)
    vals, idx, ok = _fused_search(y, norms, g, x_norm2, k_loc, n_out, ns,
                                  distance, cap)
    return _merge(vals, idx, ok, k, r_loc, n_out, mesh)


def sharded_two_pass_search(
    y: torch.Tensor, norms: torch.Tensor, g: torch.Tensor, k: int,
    mesh: Mesh, cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass search through K1 (:func:`~shadowing_tpu_torch.ops.search
    .two_pass_search`) on this rank's shard, then the k-merge; ``ok`` is
    true where every rank certified its shard."""
    r_loc, n_out = norms.shape
    vals, idx, ok = search_ops.two_pass_search(y, norms, g,
                                               min(k, r_loc * n_out), cap)
    return _merge(vals, idx, ok, k, r_loc, n_out, mesh)


def sharded_factored_search(
    E: torch.Tensor, norms: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
    x_emb: torch.Tensor, k: int, mesh: Mesh, cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass search through K2 over this rank's factored responses
    ``E`` (built from its own shard, so E's memory shrinks with the mesh),
    then the k-merge."""
    r_loc, n_out = norms.shape
    vals, idx, ok = factored_ops.two_pass_search_factored(
        E, norms, y, g, x_emb, min(k, r_loc * n_out), cap)
    return _merge(vals, idx, ok, k, r_loc, n_out, mesh)


def sharded_direct_search(
    y: torch.Tensor, x_emb: torch.Tensor, kernel: torch.Tensor, k: int,
    n_out: int, distance, R_true: int, mesh: Mesh, n_splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The literal oracle on this rank's shard, rows at or past the global
    row ``R_true`` masked out, then the k-merge: ``(distances, ids)``."""
    r_loc = y.shape[0]
    k_loc, ns = _local_k(k, r_loc, n_out, n_splits)
    vals, idx = _direct_search(y, x_emb, kernel, k_loc, n_out, ns, distance,
                               _valid_rows(r_loc, R_true, mesh))
    return _topk_merge(vals, idx + mesh.data_pos * r_loc * n_out, k, mesh)


def shard_contexts(g: torch.Tensor, x_norm2: torch.Tensor, mesh: Mesh):
    """This rank's slice of the ``B`` combined filters and context norms
    along the ``ctx`` axis."""
    B = g.shape[0]
    if B % mesh.n_ctx:
        raise ValueError(
            f"B={B} contexts not a multiple of the ctx axis ({mesh.n_ctx}) "
            "— pad the context batch (a zero context is a valid query)")
    b = B // mesh.n_ctx
    sl = slice(mesh.ctx_pos * b, (mesh.ctx_pos + 1) * b)
    return g[sl], x_norm2[sl]


def sharded_fused_search_2d(
    y: torch.Tensor, norms: torch.Tensor, g: torch.Tensor,
    x_norm2: torch.Tensor, k: int, n_out: int, distance, mesh: Mesh,
    n_splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sharded_fused_search` on a :func:`data_ctx_mesh`: each rank
    searches its ``B / n_ctx`` contexts (``g``, ``x_norm2`` are the whole
    batch) against its row shard, the k-merge runs along ``data`` only
    (payload a factor ``n_ctx`` below the 1-d mesh's), and one ``ctx``
    gather assembles the ``(B, k)`` result on every rank."""
    B = g.shape[0]
    g_loc, xn_loc = shard_contexts(g, x_norm2, mesh)
    v, i, ok = sharded_fused_search(y, norms, g_loc, xn_loc, k, n_out,
                                    distance, mesh, n_splits)
    return (mesh.all_gather(v, CTX_AXIS).reshape(B, k),
            mesh.all_gather(i, CTX_AXIS).reshape(B, k),
            mesh.all_gather(ok, CTX_AXIS).reshape(B))


def sharded_extract(y: torch.Tensor, flat_idx: torch.Tensor, n_out: int,
                    w_extract: int, mesh: Mesh):
    """Winner windows ``(B, k, C, w_extract)`` and ``(trajectory, start)``
    pairs on every rank of a mesh with ``n_data > 1``: each rank cuts the
    winners whose row it owns (:func:`extract_windows` at their rank-local
    ids) and contributes zeros elsewhere; one ``all_reduce`` sums them,
    exactly, since only the owner contributes."""
    r_loc = y.shape[0]
    traj, t0 = flat_idx // n_out, flat_idx % n_out
    ltraj = traj - mesh.data_pos * r_loc
    own = (ltraj >= 0) & (ltraj < r_loc)
    paths = extract_windows(y, ltraj.clamp(0, r_loc - 1) * n_out + t0, n_out,
                            w_extract)
    paths = torch.where(own[..., None, None], paths, 0.0)
    return mesh.all_reduce(paths), torch.stack([traj, t0], dim=-1)


def sharded_finalize_shadow(y, flat_idx, x_emb, kernel, n_out, w_extract,
                            distance, select_in, mesh: Mesh):
    """The winners' exact rescore and the stable ascending sort, the same on
    every rank: ``(dists, paths, idces)``.

    ``flat_idx`` is sorted first so the stable sort yields the canonical
    (distance, flat id) order: every route returns the same winner order
    even when distinct windows tie in f32 distance. On one rank the winners
    are read out of ``y`` by id: their input windows embedded where they lie
    (:func:`~shadowing_tpu_torch.ops.finalize.gather_embed`), and after the
    sort each whole window copied once in its final order
    (:func:`~shadowing_tpu_torch.ops.finalize.extract_windows`). Across
    ranks the windows are extracted and summed over the mesh first
    (:func:`sharded_extract`), then embedded with ``embed_windows``, the
    same reduction."""
    with span("psmc.finalize"):
        flat_idx = torch.sort(flat_idx, dim=-1).values
        if mesh.n_data == 1:
            in_pos = _in_positions(select_in, y.shape[1], w_extract, y.device)
            e = gather_embed(y, flat_idx, n_out, in_pos, kernel)
            dists, order = torch.sort(distance.forward(x_emb[:, None, :], e),
                                      dim=-1, stable=True)
            flat_idx = torch.gather(flat_idx, 1, order)
            paths = extract_windows(y, flat_idx, n_out, w_extract)
            idces = torch.stack([flat_idx // n_out, flat_idx % n_out], dim=-1)
            return dists, paths, idces
        paths, idces = sharded_extract(y, flat_idx, n_out, w_extract, mesh)
        dists = _exact_rescore(x_emb, select_in(paths), kernel, distance)
        dists, order = torch.sort(dists, dim=-1, stable=True)
        paths = torch.gather(paths, 1,
                             order[..., None, None].expand_as(paths))
        idces = torch.gather(idces, 1, order[..., None].expand_as(idces))
    return dists, paths, idces


# --------------------------------------------------------------------------
# data-parallel synthesis step
# --------------------------------------------------------------------------

def sharded_synthesis_step(
    z: torch.Tensor,         # (R / n, T) this rank's seeds
    m: torch.Tensor,         # Adam moments, the same rows
    v: torch.Tensor,
    step_idx: int,           # steps taken so far
    target: torch.Tensor,    # (n_stats,)
    psi_hat: torch.Tensor,   # (J, T)
    J: int,
    mesh: Mesh,
    lr: float = 0.03,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One data-parallel synthesis (training) step: each rank takes an
    Adam step on its own seeds, and the mean loss over every seed is
    all-reduced. The gradient is that of the sum of per-seed losses, so a
    seed's step does not depend on how the seeds are split. Returns ``(z,
    m, v, loss)``, the loss at the seeds before the step."""
    from shadowing_tpu_torch.models.scattering.moments import (
        _scattering_stats_flat,
    )
    from shadowing_tpu_torch.models.scattering.synthesis import (
        _adam_step,
        _per_seed_loss,
    )

    zz = z.detach().requires_grad_()
    with fp32_exact(), torch.enable_grad():
        loss = _per_seed_loss(_scattering_stats_flat(zz, psi_hat, J),
                              target).sum()
        (grad,) = torch.autograd.grad(loss, zz)
    z, m, v = _adam_step(z, m, v, int(step_idx) + 1, grad, lr)
    total = mesh.all_reduce(loss.detach().reshape(1))[0]
    return z, m, v, total / (z.shape[0] * mesh.n_data)
