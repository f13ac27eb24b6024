"""Process groups, job-array task ids and per-rank dataset residency.

Port of :mod:`shadowing_tpu.parallel.multihost` on ``torch.distributed``.
A JAX mesh over n devices is n processes here, one per mesh position,
launched by ``torchrun`` (``python -m torch.distributed.run``) on one host
or, with ``--nnodes``, on several: the same code either way.

* **Generation** (embarrassingly parallel): the job-array task id is the
  rank (:func:`task_split`); each rank synthesises its own slice and
  writes its own files, and nothing crosses between ranks.
* **Search** (data-parallel over R): each rank loads only its own rows of
  the zero-padded dataset from disk (:func:`host_row_range`) and places
  them on its device (:func:`shard_dataset_from_local`); the search then
  moves only the k winners between ranks.

Without torchrun's environment nothing is initialised and everything runs
in-process as a world of one.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from shadowing_tpu_torch.array_types import Array, as_torch_f32, resolve_device

#: a collective that one rank enters and another never reaches fails after
#: this long instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0)) if dist.is_initialized() else 0


def _backend(device) -> str:
    """``nccl`` when every rank on this host has a card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card: NCCL refuses two ranks on
    one card)."""
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and local_ranks <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(device="cuda") -> None:
    """Form the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    A no-op without that environment and when a group exists already, so
    entry points call it unconditionally. A group that fails to form
    raises: nothing falls back to a single process.

    :param device: where the ranks compute; ``"cpu"`` always takes gloo
    """
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=TIMEOUT)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count()}`` for a
    CUDA request without an index, else ``device`` itself."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return device


def task_split(ntot: Optional[int] = None,
               tid: Optional[int] = None) -> Tuple[int, int]:
    """The job-array ``(ntot, tid)`` pair: explicit values win, else the
    world size and this rank (``(1, 0)`` without a process group)."""
    if ntot is None:
        ntot = dist.get_world_size() if dist.is_initialized() else 1
    if tid is None:
        tid = dist.get_rank() if dist.is_initialized() else 0
    if not 0 <= tid < ntot:
        raise ValueError(f"task id {tid} out of range for ntot={ntot}")
    return int(ntot), int(tid)


def host_row_range(R_true: int, mesh) -> Tuple[int, int]:
    """Global row interval ``[start, stop)`` this rank owns.

    R is zero-padded to a multiple of the mesh's data axis and each
    position owns ``R_pad / n`` consecutive rows (ranks that differ only in
    their ``ctx`` position own the same rows). Rows at ``>= R_true`` are
    padding, which :func:`shard_dataset_from_local` fills with zeros."""
    rows = -(-R_true // mesh.n_data)
    return mesh.data_pos * rows, (mesh.data_pos + 1) * rows


def shard_dataset_from_local(y_local: Array, mesh,
                             R_true: int) -> torch.Tensor:
    """This rank's zero-padded ``(R_pad / n, C, T)`` shard on its device.

    :param y_local: this rank's rows: exactly its :func:`host_row_range`
        slab, or that slab clipped at ``R_true`` (what a load from disk
        gives); the missing padding rows are zero-filled here
    :param R_true: the true global trajectory count. Pass it on to
        ``PathShadowing(..., mesh=mesh, n_trajectories=R_true)``, which then
        takes the tensor as this rank's shard and bars the padding rows.
    """
    start, stop = host_row_range(R_true, mesh)
    if y_local.ndim != 3:
        raise ValueError(f"expected (rows, C, T), got {tuple(y_local.shape)}")
    want_data = min(stop, R_true) - min(start, R_true)   # non-padding rows
    rows = y_local.shape[0]
    if rows not in (want_data, stop - start):
        raise ValueError(
            f"this process owns rows [{start}, {stop}) ({stop - start} rows, "
            f"{want_data} of them data) — got {rows} rows")
    y = as_torch_f32(y_local if isinstance(y_local, torch.Tensor)
                     else np.asarray(y_local), mesh.device)
    if rows < stop - start:
        y = torch.cat([y, y.new_zeros((stop - start - rows, *y.shape[1:]))])
    return y
