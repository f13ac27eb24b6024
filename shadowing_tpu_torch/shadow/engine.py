"""Path shadowing engine: window norms → two-pass search → extract → rescore.

Port of :mod:`shadowing_tpu.shadow.engine` (the single-device routes).
Every dataset window is scored against each context through the quadratic
expansion ``‖h(x) - h(y_t)‖² = ‖h(x)‖² - 2⟨h(x), h(y_t)⟩ + ‖h(y_t)‖²``: the
window norms are cached per engine, and the cross term goes through one of
the two hand-written pass-1 kernels — the per-context Toeplitz kernel below
``FACTORED_MIN_B`` contexts, the factored-E kernel at or above it. Pass 2
rescores the candidate blocks exactly and certifies the k winners; a failed
certification is redone at an escalated cap, then by the literal
``"direct"`` oracle. Winners are re-embedded and re-scored directly, so
returned distances carry no expansion round-off, and are returned in the
canonical (distance, flat id) order.

Routes (``method=``): ``"kernel"`` (the JAX ``"pallas"`` route), ``"fused"``
(row chunks of the fp32 cross term, the distance's own selection score and
the certified tournament top-k: any expansion distance, any filter width),
``"direct"`` (the literal oracle) and ``"auto"``, which takes the first of
kernel, fused, direct that applies. The device is explicit:
``device="cuda"`` is the default and raises when there is no card;
``device="cpu"`` runs the kernels' plain PyTorch versions.

With ``mesh=`` every rank of a :mod:`torch.distributed` world holds a row
shard and runs each route on it, and the k winners merge across the ranks
(:mod:`shadowing_tpu_torch.parallel.sharding`); without one the same code
runs on a mesh of one position, where no collective runs.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from shadowing_tpu_torch.array_types import (
    Array,
    as_numpy,
    as_torch_f32,
    dim_bct,
    fp32_exact,
    resolve_device,
)
from shadowing_tpu_torch.data.dataset import TimeSeriesDataset
from shadowing_tpu_torch.ops import factored as factored_ops
from shadowing_tpu_torch.ops import search as search_ops
from shadowing_tpu_torch.ops.sliding import sliding_dot
from shadowing_tpu_torch.ops.topk import (
    merge_min,
    topk_min_batched,
    topk_min_sort,
)
from shadowing_tpu_torch.parallel import sharding as psh
from shadowing_tpu_torch.parallel.multihost import host_row_range
from shadowing_tpu_torch.pricing.hedged_mc import compute_smile_batch
from shadowing_tpu_torch.shadow.context import ContextManager, PredictionContext
from shadowing_tpu_torch.shadow.distance import PathDistance
from shadowing_tpu_torch.shadow.embedding import PathEmbedding, embed_windows
from shadowing_tpu_torch.stats.proba import DiscreteProba, Softmax, Uniform

METHODS = ("auto", "kernel", "fused", "direct")
#: bytes of device memory kept free for temporaries beside resident E
_HEADROOM = 2 << 30
#: budget for intermediates on the CPU (no device query there)
_CPU_BUDGET = 1 << 30


def _memory_budget(device: torch.device) -> int:
    """Byte budget for intermediate tensors: a quarter of the card's free
    memory (leaving room for the dataset, norms and E), 1 GB on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(free // 4, 256 << 20)
    return _CPU_BUDGET


def _free_bytes(device: torch.device) -> int:
    """Device memory free for a new resident tensor."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return 4 * _CPU_BUDGET


def _contexts(x_context: Array) -> Array:
    """Contexts as a ``(B, C, w)`` tensor or float32 array."""
    if not isinstance(x_context, torch.Tensor):
        x_context = np.asarray(x_context, dtype=np.float32)
    return dim_bct(x_context)


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
    ``(trajectory, start)`` pairs ``(B, k, 2)``."""
    C = y.shape[1]
    traj = flat_idx // n_out
    t0 = flat_idx % n_out
    ch = torch.arange(C, device=y.device)[:, None]
    pos = t0[..., None, None] + torch.arange(w_extract, device=y.device)
    paths = y[traj[..., None, None], ch, pos]
    return paths, torch.stack([traj, t0], dim=-1)


def _exact_rescore(x_emb: torch.Tensor, in_paths: torch.Tensor,
                   kernel: torch.Tensor, distance: PathDistance) -> torch.Tensor:
    return distance.forward(x_emb[:, None, :], embed_windows(in_paths, kernel))


def _aggregate_predictions(distances, paths, to_predict, proba_name, eta,
                           select_out):
    proba = PathShadowing.init_averaging_proba(proba_name,
                                               distances[:, :, None], eta)
    values = to_predict(select_out(paths))
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values), device=paths.device)
    return proba.avg(values, axis=1), proba.std(values, axis=1)


def _smile_inputs(dists, out_paths, eta: float, x_init: float):
    """``(B, k, h)`` futures -> ``(B, k, h+1)`` prices anchored at ``x_init``
    plus Gaussian-kernel path weights."""
    fut = out_paths[:, :, 0, :]
    lnx = torch.cat([torch.zeros_like(fut[..., :1]),
                     torch.cumsum(fut, dim=-1)], dim=-1)
    prices = torch.exp(lnx) * x_init
    w = Softmax(dists, eta).weights_like(fut[..., 0], axis=1)
    return prices, w


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

class PathShadowing:
    """Scan a generated dataset for paths shadowing an observed context.

    :param embedding: dimensionality reduction of a path window
    :param distance: distance between embedded windows
    :param dataset: ``(R, C, T)`` array or tensor, directory of ``.npy``
        shards, or :class:`TimeSeriesDataset`
    :param context: what is matched vs predicted
        (default: :class:`PredictionContext` with no horizon)
    :param device: where the dataset lives and every step runs:
        ``"cuda"`` (default; raises without a card) or ``"cpu"``; with a
        :class:`~shadowing_tpu_torch.parallel.Mesh`, the mesh's device
    :param mesh: run the pipeline sharded over the ranks of a mesh: a
        :class:`~shadowing_tpu_torch.parallel.Mesh`, its size (built by
        :func:`~shadowing_tpu_torch.parallel.data_mesh` on ``device``; it
        must equal the world size) or ``None`` (this process alone). Each
        rank holds its rows of the dataset, zero-padded to the mesh, and
        every rank returns the same results as ``mesh=None``.
    :param n_trajectories: the true trajectory count. Rows at or past it
        never win a search. With a mesh, a ``dataset`` of fewer rows is this
        rank's shard of the padded dataset
        (:func:`~shadowing_tpu_torch.parallel.shard_dataset_from_local`).
        Default: every row of ``dataset`` is data.
    """

    #: context batches at least this large route pass 1 through the
    #: factored-E kernel (its cost is ~flat in B, the Toeplitz kernel's is
    #: linear). On an NVIDIA H100 80GB HBM3 at 700 W, 32,768 x 4,096 rows,
    #: w = d = 20, chip_smoke.py's sweep reads (Toeplitz | factored, ms)
    #: 1.86 | 4.28 at B = 8, 3.34 | 4.46 at 16 and 6.29 | 5.03 at 32: the
    #: kernels cross between 16 and 32 contexts, so 8 routes B = 8..16 to
    #: the slower one there. The value waits for a benchmark of whole calls
    #: (the factored route also pays E's build and memory).
    FACTORED_MIN_B = 8

    def __init__(
        self,
        embedding: PathEmbedding,
        distance: PathDistance,
        dataset: Union[Array, Path, str, TimeSeriesDataset],
        context: Optional[ContextManager] = None,
        mesh: Union[None, int, psh.Mesh] = None,
        n_trajectories: Optional[int] = None,
        *,
        device: Union[None, str, torch.device] = None,
    ):
        if isinstance(dataset, (str, Path)):
            dataset = TimeSeriesDataset(dpath=dataset, R=None)
        if isinstance(dataset, TimeSeriesDataset):
            dataset = dataset.load()
        if mesh is not None and not isinstance(mesh, psh.Mesh):
            mesh = psh.data_mesh(int(mesh), device=device or "cuda")
        if isinstance(mesh, psh.Mesh):
            if device is not None and resolve_device(device).type != \
                    mesh.device.type:
                raise ValueError(f"device={device!r} conflicts with the "
                                 f"mesh's device {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device or "cuda")
        #: the mesh as given (``None``: this process alone)
        self.mesh = mesh
        # the mesh every step runs on: a mesh of one position without one
        self._mesh = mesh or psh.local_mesh(self.device)
        self._R = n_trajectories
        self.dataset = dataset
        self.embedding = embedding
        self.distance = distance
        self.context = context or PredictionContext(horizon=None)

        self._y: Optional[torch.Tensor] = None      # device dataset (R, C, T)
        self._norms: Optional[torch.Tensor] = None  # cached window norms
        self._E: Optional[torch.Tensor] = None      # cached factored responses
        #: (B, k) -> certified escalated cap: after a certification failure
        #: that the wider-cap retry fixed, same-shape searches go straight
        #: to the wider cap (one redo per shape, not per chunk)
        self._cap_memo: dict = {}
        #: one line per distinct routing decision (route picked, gates
        #: granted or declined with their byte math)
        self.routing_log: list = []
        #: metrics of the most recent public call (entry, wall seconds,
        #: route, shapes, redo count)
        self.last_metrics: dict = {}
        self._last_search: dict = {}

    def _log_route(self, msg: str) -> None:
        if msg not in self.routing_log:
            self.routing_log.append(msg)

    def _record_metrics(self, entry: str, t0: float, *, B: int, k: int,
                        redo_contexts: int = 0, **extra) -> None:
        self.last_metrics = {
            "entry": entry,
            "wall_s": time.perf_counter() - t0,
            "B": B,
            "k": k,
            **self._last_search,
            "factored": self._E is not None,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "redo_contexts": redo_contexts,
            **extra,
        }

    # -- device state ----------------------------------------------------
    @property
    def y(self) -> torch.Tensor:
        """This rank's rows of the dataset, zero-padded to the mesh, float32
        ``(R_pad / n, C, T)`` on the engine's device (without a mesh, the
        whole dataset)."""
        if self._y is None:
            data = dim_bct(self.dataset)
            rows = data.shape[0]
            if rows < self.R:     # this rank's shard of the padded dataset
                start, stop = host_row_range(self.R, self._mesh)
                if rows != stop - start:
                    raise ValueError(
                        f"a dataset of {rows} rows below n_trajectories="
                        f"{self.R} must be this rank's shard of "
                        f"{stop - start} rows: assemble it with "
                        "shadowing_tpu_torch.parallel.shard_dataset_from_local")
                self._y = as_torch_f32(data, self.device)
            else:
                self._y = psh.shard_dataset(data, self._mesh)
        return self._y

    @property
    def R(self) -> int:
        """The true trajectory count (without the mesh's padding rows)."""
        if self._R is None:
            return dim_bct(self.dataset).shape[0]
        return self._R

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return as_torch_f32(a, self.device)

    def _plan(self) -> tuple[np.ndarray, int]:
        shape = dim_bct(self.dataset).shape
        kernel, n_out = self.context.conv_plan(self.embedding.kernel,
                                               shape[-1])
        if kernel.shape[1] != shape[1]:
            raise ValueError(
                f"embedding/context expect {kernel.shape[1]}-channel data "
                f"(embedding kernel has {self.embedding.kernel.shape[1]} "
                f"channels, the context manager adds "
                f"{self.context.out_channels()}) but the dataset has "
                f"{shape[1]} channels — build the embedding with a "
                f"(d, C, w) kernel matching the dataset"
            )
        return kernel, n_out

    def _auto_splits(self, B: int, n_out: int, d: int,
                     method: str = "direct") -> int:
        """Row chunks for the fused route and the direct oracle. Per window
        the direct oracle holds the embedding (d), the broadcast difference
        (B * d), the distances and their sort (values plus int64 ids,
        twice); the fused route holds no embedding, only the cross term and
        the scores (2 per context) and the sort (6 per context). Sized for
        this rank's rows, and its share of a card that ranks share."""
        if method == "fused":
            per_row = 4 * n_out * (1 + 8 * B)
        else:
            per_row = 4 * n_out * (d + B * (d + 8))
        budget = _memory_budget(self.device) // self._mesh.ranks_per_device
        return max(1, -(-self.y.shape[0] * per_row // budget))

    def _kernel_ok(self, kernel: np.ndarray) -> bool:
        """Whether the two-pass kernel search applies: a distance whose
        selection score is ``norm2 - 2 * cross`` and a filter no wider than
        ``MAX_WIDTH``."""
        if not (self.distance.supports_expansion
                and self.distance.kernel_score_form):
            self._log_route(
                f"kernel declined: distance {type(self.distance).__name__} "
                "lacks the norm2 - 2*cross expansion form")
            return False
        if kernel.shape[-1] > search_ops.MAX_WIDTH:
            self._log_route(
                f"kernel declined: filter width {kernel.shape[-1]} > "
                f"MAX_WIDTH {search_ops.MAX_WIDTH}")
            return False
        return True

    def _factored_ok(self, kernel: np.ndarray, n_out: int, B: int) -> bool:
        """Whether pass 1 should use the factored responses: enough contexts,
        an embedding narrow enough for the kernel's registers, and an E of
        this rank's rows that fits its share of the device's free memory
        beside 2 GB of headroom.

        On a mesh the ranks may decide differently (free memory is each
        rank's own): neither kernel call holds a collective, and both
        routes end in the same k-merge."""
        d = kernel.shape[0]
        if B < self.FACTORED_MIN_B:
            self._log_route(
                f"factored declined: B={B} < FACTORED_MIN_B="
                f"{self.FACTORED_MIN_B} (Toeplitz pass 1 at small B)")
            return False
        if d > factored_ops.MAX_DIM:
            self._log_route(
                f"factored declined: embedding dim {d} > MAX_DIM="
                f"{factored_ops.MAX_DIM}")
            return False
        if self._E is not None:
            self._log_route(f"factored pass-1 routed: B={B}, E="
                            f"{self._E.numel() * 4 / 1e9:.2f} GB resident")
            return True
        e = factored_ops.e_bytes(self.y.shape[0], n_out, d)
        free = (_free_bytes(self.device) // self._mesh.ranks_per_device
                - _HEADROOM)
        if e > free:
            self._log_route(
                f"factored declined: E needs {e / 1e9:.2f} GB but only "
                f"{free / 1e9:.2f} GB free (after 2 GB headroom)")
            return False
        self._log_route(f"factored pass-1 routed: B={B}, E={e / 1e9:.2f} GB "
                        f"of {free / 1e9:.2f} GB free")
        return True

    def window_norms(self, n_splits: Optional[int] = None) -> torch.Tensor:
        """``‖h(y_t)‖²`` for every window of this rank's rows ``(R_pad / n,
        n_out)`` — cached; ``+inf`` on rows at or past ``R`` (the mesh's
        padding), which then never win."""
        if self._norms is None:
            kernel, n_out = self._plan()
            if n_splits is None:
                n_splits = self._auto_splits(1, n_out, self.embedding.dim)
            # the diagonal fast path is exact iff every embedding row has at
            # most one nonzero tap in the context-adjusted kernel
            diag = bool((np.count_nonzero(kernel.reshape(kernel.shape[0], -1),
                                          axis=1) <= 1).all())
            self._norms = psh.sharded_window_norms(
                self.y, self._tensor(kernel), n_out,
                min(n_splits, self.y.shape[0]), diag, self.R, self._mesh)
        return self._norms

    def factored_responses(self) -> torch.Tensor:
        """The factored responses ``E (R_pad / n, d, nblk * 128)`` of the
        plan kernel over this rank's rows — built at first use, cached until
        evicted."""
        if self._E is None:
            kernel, n_out = self._plan()
            self._E = factored_ops.build_factored(self.y, self._tensor(kernel),
                                                  n_out)
        return self._E

    # -- search ------------------------------------------------------------
    def _search(self, x_context: Array, k: int, n_splits: Optional[int],
                method: str, tournament_cap: Optional[int] = None):
        """Certified search and finalize: ``(dists (B, k), paths (B, k, C,
        w + out_times), idces (B, k, 2), n_redo)`` on the device."""
        if method not in METHODS:
            raise ValueError(
                f"unknown method {method!r}; the methods are "
                f"{', '.join(repr(m) for m in METHODS)}")
        x = as_torch_f32(_contexts(x_context), self.device)
        if x.shape[-1] != self.embedding.width:
            raise ValueError(
                f"context length {x.shape[-1]} must equal the embedding "
                f"width {self.embedding.width}")
        kernel, n_out = self._plan()
        B = x.shape[0]
        d = self.embedding.dim
        n_candidates = self.R * n_out
        if not 1 <= k <= n_candidates:
            raise ValueError(f"k={k} must be in [1, {n_candidates}] "
                             f"(= R * valid window starts)")
        if method == "auto":
            if self._kernel_ok(kernel):
                method = "kernel"
            else:
                method = ("fused" if self.distance.supports_expansion
                          else "direct")
        elif method == "kernel" and not self._kernel_ok(kernel):
            raise ValueError(
                "the kernel search requires an expansion distance with the "
                "norm2 - 2*cross score form and a filter width <= "
                f"{search_ops.MAX_WIDTH}")
        elif method == "fused" and not self.distance.supports_expansion:
            raise ValueError(
                f"the fused search requires an expansion distance; "
                f"{type(self.distance).__name__} has none")
        if n_splits is None:
            n_splits = self._auto_splits(B, n_out, d, method)
        # each chunk holds at least k candidates: any n_splits returns the
        # same result
        n_splits = max(1, min(n_splits, n_candidates // k))
        self._log_route(f"method={method} (B={B}, k={k}, R={self.R}, "
                        f"n_out={n_out})")
        self._last_search = {"method": method, "n_splits": n_splits,
                             "n_out": n_out, "R": self.R}

        # every step below runs on this rank's rows and merges the k winners
        # over the mesh; B, k, the route and the reduced ok are the same on
        # every rank, so every rank enters the same collectives
        mesh = self._mesh
        y = self.y
        kernel_t = self._tensor(kernel)
        raw_kernel = self._tensor(self.embedding.kernel)
        x_emb, x_norm2, g = _prep_context(x, raw_kernel, kernel_t)
        escalate = None

        if method == "kernel":
            norms = self.window_norms()
            cap = (tournament_cap if tournament_cap is not None
                   else self._cap_memo.get((B, k)))
            if cap is not None and tournament_cap is None:
                self._log_route(f"cap memo: routing (B={B}, k={k}) at the "
                                f"previously certified cap={cap}")
            if self._factored_ok(kernel, n_out, B):
                _, flat_idx, ok = psh.sharded_factored_search(
                    self.factored_responses(), norms, y, g, x_emb, k, mesh,
                    cap)
            else:
                _, flat_idx, ok = psh.sharded_two_pass_search(y, norms, g, k,
                                                              mesh, cap)
            # tier-1 redo: a certification failure is almost always a thin
            # order-statistic margin, so the same kernel at ~4x the block
            # slack certifies at a fraction of the oracle's cost
            esc_cap = max(k + 4 * 384, 2 * (cap or 0))

            def escalate():
                if self._E is not None and k >= 4096:
                    # pass-2 temporaries at the escalated cap are GB-scale
                    # at large k: give the retry E's memory (rebuilt lazily)
                    self._E = None
                    self._log_route("redo: evicted factored E cache for the "
                                    "escalated retry")
                if tournament_cap is None:
                    self._cap_memo[(B, k)] = esc_cap
                return psh.sharded_two_pass_search(y, norms, g, k, mesh,
                                                   esc_cap)
        elif method == "fused":
            # an uncertified context goes straight to the oracle below
            _, flat_idx, ok = psh.sharded_fused_search(
                y, self.window_norms(), g, x_norm2, k, n_out, self.distance,
                mesh, n_splits, tournament_cap)
        else:
            _, flat_idx = psh.sharded_direct_search(
                y, x_emb, kernel_t, k, n_out, self.distance, self.R, mesh,
                n_splits)
            ok = torch.ones((B,), dtype=torch.bool, device=y.device)

        rows = torch.nonzero(~ok).flatten()
        n_redo = rows.numel()
        if n_redo:
            # tier 1 retries the kernel at the escalated cap; tier 2 resolves
            # anything still uncertified with the sort-exact oracle
            flat_idx = flat_idx.clone()
            if escalate is not None:
                _, idx_esc, ok_esc = escalate()
                took = rows[ok_esc[rows]]
                flat_idx[took] = idx_esc[took]
                rows = rows[~ok_esc[rows]]
                self._log_route(
                    f"redo: escalated cap={esc_cap} certified "
                    f"{took.numel()}/{n_redo} failed contexts")
            if rows.numel():
                if self._E is not None:
                    self._E = None
                    self._log_route("redo: evicted factored E cache for the "
                                    "oracle")
                flat_idx[rows] = psh.sharded_direct_search(
                    y, x_emb[rows], kernel_t, k, n_out, self.distance, self.R,
                    mesh, self._auto_splits(rows.numel(), n_out, d))[1]

        w_extract = x.shape[-1] + self.context.get_out_times()
        dists, paths, idces = psh.sharded_finalize_shadow(
            y, flat_idx, x_emb, raw_kernel, n_out, w_extract, self.distance,
            self.context.select_in_context, mesh)
        return dists, paths, idces, n_redo

    def shadow(
        self,
        x_context: Array,
        k: int = 1,
        n_splits: Optional[int] = None,
        method: str = "auto",
        cuda: Optional[bool] = None,  # accepted for API parity; see device=
        exact_dtype: str = "float32",
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Find the ``k`` dataset windows closest to each context.

        :param x_context: ``(B, C, w)`` contexts (1-d/2-d coerced)
        :param k: number of closest paths to keep
        :param n_splits: dataset chunks of the fused route and the direct
            oracle (``None``: sized from the memory budget); results do not
            depend on it
        :param method: ``"kernel"``, ``"fused"``, ``"direct"`` or ``"auto"``
        :param exact_dtype: ``"float64"`` rescores the k winners on the host
            in double precision (selection stays float32 on the device) and
            re-sorts them, stably, so returned distances match a float64
            oracle to ~1e-15
        :return: distances ``(B, k)`` ascending, paths
            ``(B, k, C, w + out_times)``, indices ``(B, k, 2)`` as
            ``(trajectory, window start)``
        """
        del cuda
        if exact_dtype not in ("float32", "float64"):
            raise ValueError(f"exact_dtype must be float32/float64, got "
                             f"{exact_dtype!r}")
        t0 = time.perf_counter()
        dists, paths, idces, n_redo = self._search(x_context, k, n_splits,
                                                   method)
        out = as_numpy(dists), as_numpy(paths), as_numpy(idces)
        if exact_dtype == "float64":
            out = self._rescore_host_f64(x_context, out[1], out[2])
        self._record_metrics("shadow", t0, B=len(out[0]), k=k,
                             redo_contexts=n_redo, exact_dtype=exact_dtype)
        return out

    def _rescore_host_f64(self, x_context: Array, paths: np.ndarray,
                          idces: np.ndarray):
        """Re-score the winners in host float64 and re-sort (stable), closing
        the float32 rounding gap between returned distances and a float64
        oracle."""
        paths = paths.astype(np.float64)
        kernel = self.embedding.kernel.astype(np.float64)
        x_ctx = dim_bct(as_numpy(x_context).astype(np.float64))
        in_paths = np.asarray(self.context.select_in_context(paths))
        e = np.einsum("bkcw,dcw->bkd", in_paths, kernel)
        x_emb = np.einsum("bcw,dcw->bd", x_ctx, kernel)
        d = self.distance.forward_host(x_emb[:, None, :], e)      # (B, k)
        order = np.argsort(d, axis=-1, kind="stable")
        d = np.take_along_axis(d, order, axis=-1)
        paths = np.take_along_axis(paths, order[..., None, None], axis=1)
        idces = np.take_along_axis(idces, order[..., None], axis=1)
        return d, paths.astype(np.float32), idces

    def shadow_device(
        self,
        x_context: Array,
        k: int = 1,
        n_splits: Optional[int] = None,
        method: str = "auto",
        tournament_cap: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`shadow` returning device tensors. ``tournament_cap`` forces
        the block count of pass 2, or of the fused route's tournament (a
        test hook for the redo path)."""
        t0 = time.perf_counter()
        dists, paths, idces, n_redo = self._search(x_context, k, n_splits,
                                                   method, tournament_cap)
        self._record_metrics("shadow_device", t0, B=dists.shape[0], k=k,
                             redo_contexts=n_redo)
        return dists, paths, idces

    # -- prediction --------------------------------------------------------
    @staticmethod
    def init_averaging_proba(proba_name: str, distances: Array,
                             eta: Optional[float]) -> DiscreteProba:
        if proba_name == "uniform":
            return Uniform()
        if proba_name == "softmax":
            return Softmax(distances, eta)
        raise ValueError(f"unrecognized averaging proba {proba_name!r}")

    def predict_from_paths(
        self,
        distances: Array,
        paths: Array,
        to_predict: Callable[[torch.Tensor], torch.Tensor],
        proba_name: str = "softmax",
        eta: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Aggregate a functional of the out-context over shadowing paths."""
        avg, std = _aggregate_predictions(
            as_torch_f32(distances, self.device),
            as_torch_f32(paths, self.device), to_predict, proba_name, eta,
            self.context.select_out_context)
        return as_numpy(avg), as_numpy(std)

    def _smiles(self, dists, paths, Ts, Ms, eta, r, x_init):
        prices, weights = _smile_inputs(
            dists, self.context.select_out_context(paths), float(eta),
            float(x_init))
        # prices start at x_init by construction: skip validation
        return compute_smile_batch(prices, Ts, Ms, r, weights=weights,
                                   validate=False)

    def conditional_smile(
        self,
        x_context: Array,
        k: int,
        Ts,
        Ms,
        eta: float = 0.075,
        r: float = 0.0,
        x_init: float = 100.0,
        n_splits: Optional[int] = None,
        method: str = "auto",
    ):
        """Shadow then price: conditional Hedged-MC smiles, one per context."""
        t0 = time.perf_counter()
        dists, paths, _, n_redo = self._search(x_context, k, n_splits, method)
        smiles = self._smiles(dists, paths, Ts, Ms, eta, r, x_init)
        self._record_metrics("conditional_smile", t0, B=len(smiles), k=k,
                             redo_contexts=n_redo)
        return smiles

    def predict_and_smile(
        self,
        x_context: Array,
        k: int,
        to_predict: Callable[[torch.Tensor], torch.Tensor],
        Ts,
        Ms,
        eta: float = 0.1,
        eta_smile: float = 0.075,
        r: float = 0.0,
        x_init: float = 100.0,
        proba_name: str = "softmax",
        n_splits: Optional[int] = None,
        method: str = "auto",
    ):
        """One search, both products: the volatility prediction and the
        conditional Hedged-MC smiles of every context.

        :return: ``(avg (B, ...), std (B, ...), [B Smile objects])``
        """
        t0 = time.perf_counter()
        d, p, _, n_redo = self._search(x_context, k, n_splits, method)
        a, b = _aggregate_predictions(d, p, to_predict, proba_name, eta,
                                      self.context.select_out_context)
        smiles = self._smiles(d, p, Ts, Ms, eta_smile, r, x_init)
        a, b = as_numpy(a), as_numpy(b)
        self._record_metrics("predict_and_smile", t0, B=len(a), k=k,
                             redo_contexts=n_redo)
        return a, b, smiles

    def predict(
        self,
        x_context: Array,
        k: int,
        to_predict: Callable[[torch.Tensor], torch.Tensor],
        eta: Optional[float] = None,
        proba_name: str = "softmax",
        n_dataset_splits: Optional[int] = None,
        n_context_splits: int = 1,
        method: str = "auto",
        cuda: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Shadow then aggregate, ``n_context_splits`` chunks of contexts at
        a time. Each chunk's intermediates are freed before the next one
        starts, so device memory holds one chunk's search at a time.

        Contexts are padded (by repeating the last one) to a multiple of the
        chunk, and the results cut back to B: every chunk has one shape and
        one route, so a short remainder never drops below
        ``FACTORED_MIN_B`` onto the Toeplitz kernel."""
        del cuda
        t0 = time.perf_counter()
        x = _contexts(x_context)
        B = x.shape[0]
        chunk = -(-B // n_context_splits)
        pad = (-B) % chunk
        if pad:
            if isinstance(x, torch.Tensor):
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            else:
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        preds, stds, n_redo = [], [], 0
        for s in range(0, x.shape[0], chunk):
            d, p, _, n = self._search(x[s : s + chunk], k, n_dataset_splits,
                                      method)
            a, b = _aggregate_predictions(d, p, to_predict, proba_name, eta,
                                          self.context.select_out_context)
            del d, p
            preds.append(as_numpy(a))
            stds.append(as_numpy(b))
            n_redo += n
        self._record_metrics("predict", t0, B=B, k=k, redo_contexts=n_redo,
                             n_context_chunks=len(preds))
        return np.concatenate(preds)[:B], np.concatenate(stds)[:B]


# --------------------------------------------------------------------------
# several row-slice engines searched as one dataset
# --------------------------------------------------------------------------

def shadow_sharded_rows(
    engines,
    x_context: Array,
    k: int = 1,
    n_splits: Optional[int] = None,
    method: str = "auto",
    exact_dtype: str = "float32",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:meth:`PathShadowing.shadow` over several engines holding consecutive
    row slices of one dataset (same embedding, distance and context).

    The JAX package needs this where ``R * n_out`` overflows int32 flat ids;
    the port's ids are int64, so here it only keeps the API (and lets a
    dataset too large for one card be searched slice by slice). Per-engine
    exact top-k results merge into the global k smallest — exact by the
    same streaming-merge property as ``n_splits`` — and winner trajectory
    ids are offset back into the full dataset's row numbering.

    :param engines: engines over consecutive row slices, in dataset order
    :return: same contract as :meth:`PathShadowing.shadow`
    """
    if not engines:
        raise ValueError("shadow_sharded_rows needs at least one engine")
    outs = []
    offset = total = 0
    for eng in engines:
        _, n_out = eng._plan()
        k_loc = min(k, eng.R * n_out)   # at most k winners come from a slice
        d, p, i = eng.shadow(x_context, k=k_loc, n_splits=n_splits,
                             method=method, exact_dtype=exact_dtype)
        i = i.copy()
        i[..., 0] += offset
        offset += eng.R
        total += eng.R * n_out
        outs.append((d, p, i))
    if k > total:
        raise ValueError(f"k={k} exceeds the {total} total candidates")
    d, p, i = (np.concatenate([o[j] for o in outs], axis=1) for j in range(3))
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, order, axis=1),
            np.take_along_axis(p, order[..., None, None], axis=1),
            np.take_along_axis(i, order[..., None], axis=1))
