"""Gradient-based scattering-spectra synthesis (max-entropy generation).

Port of :mod:`shadowing_tpu.models.scattering.synthesis`: start each seed
from noise and descend, with Adam, until its *own* scattering-spectra
statistics match a target vector estimated on the observed series (the
microcanonical model of arXiv:2204.10177). The loss is the mean squared
mismatch of the statistics; a seed converges when its RMS mismatch falls
below ``tol``. Gradients come from ``torch.autograd.grad``; the steps are a
Python loop.

Schedule: a first segment of ``segment`` Adam steps on the whole batch,
then segments of :func:`_tail_segment` steps on the rows still active. At
every segment boundary the per-seed losses come to the host and the seeds
below ``tol`` retire: they are never stepped again. The schedule is a
function of the losses alone, so two runs from one generator, and a run
resumed from its checkpoint, step the same rows the same number of times.
(The JAX package pipelines retirement a segment late and lets a retired
seed re-enter; both packages follow the same rule at each boundary, but
their per-seed step counts, and hence their trajectories, differ.)
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from shadowing_tpu_torch.array_types import as_numpy, as_tensor, fp32_exact
from shadowing_tpu_torch.models.mrw import (
    _circulant_sqrt_spectrum,
    _omega_cov,
    _stationary_from_normals,
)
from shadowing_tpu_torch.models.scattering.moments import _scattering_stats_flat
from shadowing_tpu_torch.models.scattering.wavelets import FilterBank

#: Adam constants. b2 = 0.95: the loss is deterministic (no minibatch
#: noise), so the second moment only tracks curvature and a short memory
#: adapts the per-coordinate scale faster (the JAX package's choice).
_B1, _B2, _EPS = 0.9, 0.95, 1e-8
_F32 = np.float32


def default_lr_schedule(max_iterations: int) -> tuple:
    """Cosine 0.06 -> 0.005 over HALF the step budget (most seeds converge
    well before ``max_iterations``)."""
    return ("cos", 0.06, 0.005, max(1, max_iterations // 2))


def _lr_at(lr, t: int) -> float:
    """Learning rate at (1-based) step ``t``: a constant float, or a cosine
    schedule tuple ``("cos", lr0, lr1, horizon)`` going lr0 -> lr1 over
    ``horizon`` steps. Evaluated in float32, in the JAX package's order."""
    if isinstance(lr, tuple):
        _, lr0, lr1, horizon = lr
        frac = np.minimum(_F32(t) / _F32(horizon), _F32(1.0))
        return float(_F32(lr1) + _F32((lr0 - lr1) * 0.5)
                     * (_F32(1.0) + np.cos(_F32(np.pi) * frac)))
    return lr


def _standardize(z: torch.Tensor) -> torch.Tensor:
    z = z - z.mean(dim=-1, keepdim=True)
    return z / z.std(dim=-1, keepdim=True, correction=0)


def should_standardize(target) -> bool:
    """True when the target's mean/logvar entries say "standardized series"
    (|mean| and |logvar| ~ 0): the synthesis then evaluates the statistics
    on each seed's standardized series, so mean and variance are matched by
    construction instead of by gradient descent."""
    return bool(abs(float(target[0])) < 1e-3 and abs(float(target[1])) < 1e-3)


def _per_seed_loss(stats: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((stats - target[None]) ** 2).mean(dim=-1)


def _loss_grad(z, target, psi_hat, J, bands, standardize) -> torch.Tensor:
    """Gradient at ``z`` of the SUM of per-seed losses, so a seed's gradient
    does not depend on which other seeds share its batch. ``z`` is taken as
    a fresh leaf: no gradient flows into the tensor it was gathered from."""
    z = z.detach().requires_grad_()
    with torch.enable_grad():
        zs = _standardize(z) if standardize else z
        loss = _per_seed_loss(_scattering_stats_flat(zs, psi_hat, J, bands),
                              target)
        (g,) = torch.autograd.grad(loss.sum(), z)
    return g


def _adam_step(z, m, v, t: int, g, lr):
    """One bias-corrected Adam step at (1-based) step ``t``."""
    m = _B1 * m + (1 - _B1) * g
    v = _B2 * v + (1 - _B2) * g**2
    bc1 = float(_F32(1.0) - _F32(_B1) ** _F32(t))
    bc2 = float(_F32(1.0) - _F32(_B2) ** _F32(t))
    z = z - _lr_at(lr, t) * (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
    return z, m, v


def _optimize_segment(
    z: torch.Tensor,        # (B, T) series being optimised
    m: torch.Tensor,        # Adam state
    v: torch.Tensor,
    i0: int,                # steps already taken
    target: torch.Tensor,   # (n_stats,)
    psi_hat: torch.Tensor,  # (J, T)
    J: int,
    n_steps: int,
    lr=0.03,
    bands: tuple = None,    # per-scale support bins (FilterBank.band_hi)
    standardize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` Adam steps on every row; returns ``(z, m, v, losses)``
    with the per-seed losses of the returned ``z``."""
    with fp32_exact():
        for i in range(n_steps):
            g = _loss_grad(z, target, psi_hat, J, bands, standardize)
            z, m, v = _adam_step(z, m, v, i0 + i + 1, g, lr)
        with torch.no_grad():
            zs = _standardize(z) if standardize else z
            losses = _per_seed_loss(
                _scattering_stats_flat(zs, psi_hat, J, bands), target)
    return z, m, v, losses


def _step_active(z, m, v, active: np.ndarray, i0: int, n_steps: int, **kw):
    """:func:`_optimize_segment` on the rows ``active`` (sorted, unique) of
    ``(z, m, v)``; returns the state, written in place unless every row is
    active, and the active rows' losses. The rows are gathered into fresh
    tensors and written back by a plain scatter: no gradient or
    accumulation runs through the full state, so the result is
    deterministic on the card."""
    if active.size == z.shape[0]:
        return _optimize_segment(z, m, v, i0, n_steps=n_steps, **kw)
    idx = torch.as_tensor(active, device=z.device)
    za, ma, va, losses = _optimize_segment(z[idx], m[idx], v[idx], i0,
                                           n_steps=n_steps, **kw)
    z[idx], m[idx], v[idx] = za, ma, va
    return z, m, v, losses


def _colour_filter(target: torch.Tensor, psi_hat: torch.Tensor,
                   J: int) -> torch.Tensor:
    """Spectral colouring ``H(w)`` that maps unit white noise to the
    target's per-scale wavelet powers.

    The target stores ``logpower_j = log(<|W_j x|^2> / Var)``. For white
    noise ``<|W_j z|^2> = mean_w |psi_j|^2``, so shaping the seed spectrum by

        H(w)^2 = sum_j u_j(w) * target_p2_j / white_p2_j,
        u_j(w) = |psi_j(w)|^2 / sum_k |psi_k(w)|^2   (soft scale assignment)

    starts the optimisation with Phi_2 already matched (H = 1 on bins no
    wavelet covers).
    """
    p2_target = torch.exp(target[2 : 2 + J])             # (J,)
    S = psi_hat.abs() ** 2                               # (J, T)
    p2_white = S.mean(dim=-1)                            # (J,)
    tot = S.sum(dim=0)                                   # (T,)
    u = S / torch.clamp(tot, min=1e-20)[None]
    T = psi_hat.shape[-1]
    ar = torch.arange(T, device=psi_hat.device)
    mirror = torch.minimum(ar, T - ar)
    # overlapping wavelets mix the per-scale ratios, so refine by fixpoint:
    # predict the coloured powers analytically and correct multiplicatively
    r = p2_target / torch.clamp(p2_white, min=1e-30)
    for _ in range(3):
        h2 = torch.where(tot > 1e-12, (u * r[:, None]).sum(dim=0), 1.0)
        varc = h2[mirror].mean()                         # Var of coloured z
        achieved = (S * h2[None]).mean(dim=-1) / torch.clamp(varc, min=1e-30)
        r = r * p2_target / torch.clamp(achieved, min=1e-30)
    h2 = torch.where(tot > 1e-12, (u * r[:, None]).sum(dim=0), 1.0)
    # analytic filters only define H on non-negative bins: mirror onto the
    # negative half so the coloured spectrum stays Hermitian (real output)
    return torch.sqrt(h2)[mirror]                        # (T,) real, even


def _coloured_from_normals(z, target, psi_hat, J) -> torch.Tensor:
    """Unit-variance seeds: the unit normals ``z (B, T)`` coloured to the
    target spectrum."""
    H = _colour_filter(target, psi_hat, J)
    z = torch.fft.ifft(torch.fft.fft(z, dim=-1) * H[None], dim=-1).real
    return _standardize(z)


def _coloured_noise(generator, batch, T, target, psi_hat, J) -> torch.Tensor:
    z = torch.randn((batch, T), generator=generator, device=psi_hat.device)
    return _coloured_from_normals(z, target, psi_hat, J)


# intermittency grid for the auto-calibrated init: 0.0 = plain coloured
# noise (Gaussian envelopes), so non-intermittent targets never regress
_INIT_LAMBDAS = (0.0, 0.15, 0.25, 0.35)


def _calibrated_from_normals(z, zr, zi, target, psi_hat, J, sq_oms,
                             bands=None) -> torch.Tensor:
    """Coloured seeds modulated by a log-normal (MRW-style) volatility
    envelope, the intermittency picked PER SEED by initial loss.

    ``z (B, T)`` are the normals of the coloured base; ``zr, zi (B, M)``
    those of the envelope field, the SAME for every candidate intensity
    (``sq_oms`` holds one circulant spectrum per non-zero grid entry). Each
    seed keeps the candidate with the smallest initial mismatch (the first
    on ties), plain coloured noise included.
    """
    T = z.shape[-1]
    zc = _coloured_from_normals(z, target, psi_hat, J)
    # no MRW-style mean shift on omega: a constant factor exp(mean_om) on z
    # cancels exactly in the per-seed standardization
    cands = torch.stack([zc] + [
        _standardize(zc * torch.exp(_stationary_from_normals(zr, zi, sq, T)))
        for sq in sq_oms])                               # (n_cand, B, T)
    losses = torch.stack([
        _per_seed_loss(_scattering_stats_flat(c, psi_hat, J, bands), target)
        for c in cands])                                 # (n_cand, B)
    best = torch.argmin(losses, dim=0)                   # (B,)
    return torch.take_along_dim(cands, best[None, :, None], dim=0)[0]


def _auto_seeds(generator, batch, T, target, psi_hat, J,
                bands=None) -> torch.Tensor:
    """Draw the normals of :func:`_calibrated_from_normals` (base, then the
    envelope's real and imaginary parts) and pick each seed's candidate."""
    sq = np.stack([_circulant_sqrt_spectrum(_omega_cov(T, lam, T))
                   for lam in _INIT_LAMBDAS if lam > 0.0])
    sq_oms = torch.as_tensor(sq, dtype=torch.float32, device=psi_hat.device)
    draw = lambda n: torch.randn((batch, n), generator=generator,
                                 device=psi_hat.device)
    z, zr, zi = draw(T), draw(sq.shape[-1]), draw(sq.shape[-1])
    return _calibrated_from_normals(z, zr, zi, target, psi_hat, J, sq_oms,
                                    bands)


def _tail_segment(segment: int) -> int:
    """Segment length after the first segment: ``segment // 4`` (>= 25).

    Retirement is observed only at segment boundaries, so a seed pays up to
    one segment past its convergence; nothing converges in the first
    segment, which therefore stays long."""
    return max(25, segment // 4)


def synthesize_batch(
    generator: torch.Generator,
    target,
    bank: FilterBank,
    batch: int,
    max_iterations: int = 1000,
    tol: float = 1e-2,
    segment: int = 100,
    lr=None,
    verbose: bool = False,
    checkpoint_path=None,
    work_log: dict = None,
    init: str = "auto",
    checkpoint_min_interval_s: float = 30.0,
    mesh=None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Synthesise ``batch`` series matching ``target`` statistics on the
    generator's device, drawing every random number from ``generator``.

    Returns (normalised series ``(batch, T)`` float32 on that device,
    per-seed RMS losses as a host array). The caller rescales by the target
    std / adds the target mean.

    :param target: ``(n_stats,)`` statistic vector (tensor or array)
    :param checkpoint_path: optional ``.npz`` file; the optimiser state
        (keys ``z m v done active rms_full``) is saved there at segment
        boundaries, so an interrupted generation resumes mid-shard on the
        same schedule. It is deleted when the shard finishes.
    :param checkpoint_min_interval_s: minimum wall seconds between
        checkpoint writes (0: write at every boundary). Writes cannot
        change results.
    :param work_log: optional dict; filled with ``seed_steps`` (per-seed
        Adam steps paid), ``steps`` (steps of the longest-running seed),
        ``t_loop_s`` and ``t_init_s``.
    :param lr: ``None`` (default): :func:`default_lr_schedule`; a float
        keeps a constant rate
    :param init: ``"auto"`` (default): spectrum-coloured noise modulated
        by an MRW-style volatility envelope whose intermittency is picked
        per seed by initial loss (:func:`_calibrated_from_normals`);
        ``"coloured"``: the spectrum only; ``"white"``: unit normals
    :param mesh: synthesise data-parallel over the ranks of a
        :class:`~shadowing_tpu_torch.parallel.Mesh` (or its size), whose
        ``data`` axis must divide ``batch``. Every rank draws the whole
        batch's initial seeds from ``generator`` (seeded alike on every
        rank) and keeps its rows, so the start is the one of ``mesh=None``;
        each rank steps and retires its own rows on the same schedule, keeps
        its own checkpoint (the position is added to the file name), and
        one ``all_gather`` returns the whole batch on every rank. Series
        agree with ``mesh=None`` up to float rounding, which differs with
        the batch's size and which Adam amplifies (~1e-3 after tens of
        steps).
    """
    t_start = time.monotonic()
    if init not in ("auto", "coloured", "white"):
        raise ValueError(
            f"init must be 'auto', 'coloured' or 'white', got {init!r}")
    if lr is None:
        lr = default_lr_schedule(max_iterations)
    device = generator.device
    n_pos, pos = 1, 0
    if mesh is not None:
        from shadowing_tpu_torch.parallel import Mesh, data_mesh

        if not isinstance(mesh, Mesh):
            mesh = data_mesh(int(mesh), device=device)
        n_pos, pos = mesh.n_data, mesh.data_pos
        if batch % n_pos:
            raise ValueError(
                f"batch {batch} must be a multiple of the mesh size {n_pos}")
    rows = batch // n_pos                # this rank's seeds
    target = as_tensor(target).to(device=device, dtype=torch.float32)
    std = should_standardize(target)
    T, J = bank.T, bank.J
    bands = bank.band_hi or None
    psi = torch.as_tensor(bank.psi_hat, device=device)
    with fp32_exact(), torch.no_grad():
        if init == "auto":
            z = _auto_seeds(generator, batch, T, target, psi, J, bands)
        elif init == "coloured":
            z = _coloured_noise(generator, batch, T, target, psi, J)
        else:
            z = torch.randn((batch, T), generator=generator, device=device)
    z = z[pos * rows : (pos + 1) * rows].clone() if n_pos > 1 else z
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    t_init = time.monotonic() - t_start

    # ``rms_full`` holds each seed's RMS at its last boundary; retired seeds
    # keep the value they retired with
    active = np.arange(rows)
    rms_full = np.full(rows, np.inf, np.float32)
    seed_steps = 0
    done = 0
    if checkpoint_path is not None:
        checkpoint_path = Path(checkpoint_path)
        if n_pos > 1:
            checkpoint_path = checkpoint_path.with_name(
                f"{checkpoint_path.stem}.{pos}of{n_pos}"
                f"{checkpoint_path.suffix}")
        if checkpoint_path.exists():
            ckpt = np.load(checkpoint_path)
            if (ckpt["z"].shape == (rows, T)
                    and int(ckpt["done"]) <= max_iterations):
                z, m, v = (torch.from_numpy(ckpt[k]).to(device)
                           for k in ("z", "m", "v"))
                done = int(ckpt["done"])
                active = np.asarray(ckpt["active"])
                rms_full = np.asarray(ckpt["rms_full"])
                if verbose:
                    print(f"  resumed synthesis from step {done} "
                          f"({rows - active.size}/{rows} already converged)",
                          flush=True)
    tail = _tail_segment(segment)
    last_save = time.monotonic()
    kw = dict(target=target, psi_hat=psi, J=J, lr=lr, bands=bands,
              standardize=std)
    while done < max_iterations and active.size:
        n = min(segment if done == 0 else tail, max_iterations - done)
        z, m, v, losses = _step_active(z, m, v, active, done, n, **kw)
        rms = np.sqrt(losses.cpu().numpy())
        rms_full[active] = rms
        done += n
        seed_steps += active.size * n
        active = active[rms >= tol]
        if verbose:
            print(f"  synthesis step {done:5d}: rms mismatch "
                  f"median={np.median(rms_full):.4f} max={rms_full.max():.4f}"
                  f" | {rows - active.size}/{rows} converged", flush=True)
        if (checkpoint_path is not None and
                time.monotonic() - last_save >= checkpoint_min_interval_s):
            last_save = time.monotonic()
            tmp = checkpoint_path.with_suffix(".tmp.npz")
            np.savez(tmp, z=z.cpu().numpy(), m=m.cpu().numpy(),
                     v=v.cpu().numpy(), done=done, active=active,
                     rms_full=rms_full)
            tmp.replace(checkpoint_path)
    if not np.isfinite(rms_full).all():
        # no segment ran and no checkpoint held the losses (a zero
        # budget): evaluate the losses only
        _, _, _, losses = _optimize_segment(z, m, v, done, n_steps=0, **kw)
        rms_full = np.sqrt(losses.cpu().numpy())
    if std:
        # the loss/rms describe the per-seed standardized series — return
        # exactly that (the raw variable may carry a residual mean/scale the
        # projection absorbed)
        z = _standardize(z)
    if n_pos > 1:
        # every rank's rows, in position order; the work summed over ranks
        # and the steps of the longest-running rank
        z = mesh.all_gather(z).reshape(batch, T)
        rms_full = as_numpy(mesh.all_gather(
            torch.from_numpy(rms_full).to(device)).reshape(batch))
        work = mesh.all_gather(torch.tensor([seed_steps, done], device=device))
        seed_steps, done = int(work[:, 0].sum()), int(work[:, 1].max())
    if work_log is not None:
        work_log["seed_steps"] = seed_steps
        work_log["steps"] = done
        work_log["t_loop_s"] = time.monotonic() - t_start
        work_log["t_init_s"] = t_init
    if checkpoint_path is not None and checkpoint_path.exists():
        checkpoint_path.unlink()  # shard finished: drop the mid-shard state
    return z, rms_full
