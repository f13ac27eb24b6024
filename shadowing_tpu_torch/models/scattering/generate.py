"""Scattering-spectra analysis and dataset generation (public API).

Port of :mod:`shadowing_tpu.models.scattering.generate`: estimate the
scattering-spectra statistics of an observed series, then synthesise ``R``
independent series matching them, with an on-disk cache compatible with
job-array sharding (each task writes its own shard; ``batch_npy_files``
regroups).

Scale handling: the statistic vector is estimated on the *standardised*
log-returns (all Phi statistics are scale- and mean-invariant, so this is
lossless), seeds are synthesised at unit scale, and outputs are rescaled by
the observed std/mean.
"""
from __future__ import annotations

import hashlib
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array, as_numpy, resolve_device
from shadowing_tpu_torch.data.price_data import PriceData
from shadowing_tpu_torch.models.scattering.moments import (
    ScatteringStats,
    scattering_stats,
)
from shadowing_tpu_torch.models.scattering.synthesis import synthesize_batch
from shadowing_tpu_torch.models.scattering.wavelets import build_filter_bank


def _as_log_returns(x: Union[PriceData, Array]) -> np.ndarray:
    dlnx = x.dlnx if isinstance(x, PriceData) else as_numpy(x)
    return np.ravel(dlnx).astype(np.float64)


def target_stats(dlnx: np.ndarray, J: int) -> torch.Tensor:
    """Statistics of the standardised series ``dlnx``, float32 on the CPU.

    Always the CPU: every job-array task then derives the same vector, and
    hence the same cache tag, whatever card it runs on."""
    z = (dlnx - dlnx.mean()) / dlnx.std()
    return scattering_stats(torch.as_tensor(z, dtype=torch.float32),
                            build_filter_bank(len(z), J))


def analyze(x: Union[PriceData, Array], J: int = 9) -> ScatteringStats:
    """Scattering-spectra statistics of an observed series (log-returns),
    computed on the CPU."""
    dlnx = _as_log_returns(x)
    std = dlnx.std()
    flat = target_stats(dlnx, J).numpy().copy()
    # restore the raw mean/variance in the named view
    flat[0] = dlnx.mean() * np.sqrt(len(dlnx)) / std
    flat[1] = np.log(std**2)
    return ScatteringStats(J=J, flat=flat, T=len(dlnx))


def _shard_seed(seed: int, shard: int) -> int:
    """Seed of shard ``shard``'s generator: disjoint, reproducible streams
    per (seed, shard), whatever the number of shards."""
    return int(np.random.SeedSequence([seed, shard]).generate_state(
        1, np.uint64)[0])


def generate(
    x: Union[PriceData, Array],
    R: int = 1,
    J: int = 9,
    T: Optional[int] = None,
    gen_log_returns: bool = True,
    tol_optim: float = 1e-2,
    max_iterations: int = 1000,
    cache_path: Optional[Union[Path, str]] = None,
    load_cache: bool = True,
    verbose: bool = False,
    cuda: Optional[bool] = None,   # signature parity; placement is `device`
    seed: int = 0,
    batch: int = 256,
    lr=None,
    mesh=None,
    init: str = "auto",
    shard_logs: Optional[list] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Generate ``R`` synthetic log-return trajectories calibrated to ``x``.

    :param x: observed series (``PriceData`` or log-return array)
    :param R: number of trajectories
    :param J: number of dyadic wavelet scales
    :param T: trajectory length (default: next power of two >= observed)
    :param tol_optim: per-seed RMS statistic mismatch target
    :param max_iterations: optimiser step budget per seed
    :param cache_path: directory for the generation cache (shards of
        ``batch`` trajectories, resumable: a crashed run re-uses finished
        shards and resumes the interrupted one from its checkpoint)
    :param seed: base seed; shard ``i`` draws from a ``torch.Generator``
        seeded by ``SeedSequence([seed, i])``, so every shard draws
        ``batch`` rows and row content does not depend on ``R``
    :param init: seed initialisation, ``"auto"``, ``"coloured"`` or
        ``"white"`` (see :func:`synthesize_batch`)
    :param shard_logs: if a list, one dict per shard is appended: the
        shard's ``work_log`` and per-seed ``rms`` (or ``from_cache``), and
        its ``wall_s``
    :param mesh: synthesise every shard data-parallel over the ranks of a
        :class:`~shadowing_tpu_torch.parallel.Mesh` (or its size): same
        schedule and results as ``mesh=None`` up to Adam-amplified float
        rounding (see :func:`synthesize_batch`), the whole result on every
        rank; the first rank writes the cache
    :param device: where the seeds are synthesised and the result lives:
        ``"cuda"`` (default; raises without a card) or ``"cpu"``; with a
        mesh, the mesh's device. The cache tag includes its type (the CPU
        and CUDA generators draw different streams).
    :return: ``(R, 1, T)`` float32 log-returns on ``device``
    """
    del cuda
    writer = True
    if mesh is not None:
        from shadowing_tpu_torch.parallel import Mesh, data_mesh

        if not isinstance(mesh, Mesh):
            mesh = data_mesh(int(mesh), device=device)
        device = mesh.device
        writer = mesh.data_pos == mesh.ctx_pos == 0
    device = resolve_device(device)
    if not gen_log_returns:
        raise NotImplementedError(
            "only log-return generation is supported (the reference "
            "workflow)")
    dlnx = _as_log_returns(x)
    if T is None:
        T = 1 << int(np.ceil(np.log2(len(dlnx))))
    mean, std = dlnx.mean(), dlnx.std()

    # target statistics on the standardised observed series: wavelet stats
    # are time-averages, so estimating on the (shorter) observed grid and
    # matching on the T grid is consistent scale by scale
    target = target_stats(dlnx, J)
    bank_gen = build_filter_bank(T, J)

    cache_dir = None
    if cache_path is not None:
        tag = hashlib.sha1(
            target.numpy().tobytes()
            + f"T{T}_J{J}_tol{tol_optim:g}_it{max_iterations}_lr{lr}"
            f"_seed{seed}_b{batch}_init{init}_{device.type}".encode()
        ).hexdigest()[:12]
        cache_dir = Path(cache_path) / f"scatgen_{tag}"
        cache_dir.mkdir(parents=True, exist_ok=True)

    out = torch.empty((R, T), dtype=torch.float32, device=device)
    n_shards = -(-R // batch)
    t_start = time.perf_counter()
    for i in range(n_shards):
        t_shard = time.perf_counter()
        shard_file = (cache_dir / f"shard{i:05d}.npy"
                      if cache_dir is not None else None)
        log = {}
        cached = load_cache and shard_file is not None and shard_file.exists()
        if mesh is not None:
            # the ranks must agree: a synthesis ends in a collective
            cached = bool(mesh.all_true(torch.tensor([cached], device=device)))
        if cached:
            z = torch.from_numpy(np.load(shard_file)).to(device)
            log["from_cache"] = True
        else:
            generator = torch.Generator(device=device).manual_seed(
                _shard_seed(seed, i))
            ckpt = (cache_dir / f"shard{i:05d}.ckpt.npz"
                    if cache_dir is not None else None)
            z, rms = synthesize_batch(
                generator, target, bank_gen, batch=batch,
                max_iterations=max_iterations, tol=tol_optim, lr=lr,
                verbose=verbose, checkpoint_path=ckpt, work_log=log,
                init=init, mesh=mesh,
            )
            log["rms"] = rms
            if shard_file is not None and writer:
                np.save(shard_file, as_numpy(z))
            if verbose:
                done = min((i + 1) * batch, R)
                rate = done / (time.perf_counter() - t_start)
                print(f"shard {i + 1}/{n_shards}: rms mismatch median "
                      f"{np.median(rms):.4f} | {rate:.1f} paths/s", flush=True)
        r0 = i * batch
        out[r0 : min(r0 + batch, R)] = z[: min(batch, R - r0)]
        if shard_logs is not None:
            log["wall_s"] = time.perf_counter() - t_shard
            shard_logs.append(log)
    out.mul_(float(std)).add_(float(mean))
    return out[:, None, :]
