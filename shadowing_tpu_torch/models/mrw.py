"""Multifractal Random Walk (MRW) path generator.

Port of :mod:`shadowing_tpu.models.mrw`. Model (Bacry–Muzy–Delour):
log-price increments

    dX_k = eps_k * exp(omega_k),

where ``eps`` is (fractional) Gaussian noise with Hurst ``H`` and scale
``sigma``, and ``omega`` is a Gaussian log-correlated field with covariance
``Cov(omega_i, omega_j) = lam^2 * ln(L / (|i-j| + 1))`` for ``|i-j| < L``
and mean ``-Var(omega)``, so that ``E[exp(2*omega)] = 1``.

Both Gaussian series are sampled by circulant embedding (Davies–Harte): the
spectra are computed once in host float64 numpy, the samples are one
complex64 ``torch.fft.ifft`` per batch on the generator's device. Every
normal is drawn from a ``torch.Generator`` on that device, seeded by
``seed``: generation is deterministic per (seed, parameters, device).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from shadowing_tpu_torch.array_types import as_numpy, resolve_device


def _circulant_sqrt_spectrum(cov_row: np.ndarray) -> np.ndarray:
    """Eigenvalue sqrt of the circulant embedding of a stationary covariance.

    ``cov_row`` holds c(0), c(1), ..., c(n-1); the embedding has size 2n-2.
    Slightly negative eigenvalues from truncation are clipped to zero (the
    standard Davies–Harte fallback; the resulting bias is O(clip mass)).
    """
    row = np.concatenate([cov_row, cov_row[-2:0:-1]])  # size 2n-2
    eig = np.fft.fft(row).real
    return np.sqrt(np.maximum(eig, 0.0))


def _fgn_cov(n: int, H: float, sigma: float) -> np.ndarray:
    """Autocovariance of fractional Gaussian noise with Hurst ``H``."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 * sigma**2
            * (np.abs(k + 1) ** (2 * H) - 2 * np.abs(k) ** (2 * H)
               + np.abs(k - 1) ** (2 * H)))


def _omega_cov(n: int, lam: float, L: int) -> np.ndarray:
    """Log-correlated covariance ``lam^2 ln(L / (tau + 1))``, cut at L."""
    tau = np.arange(n, dtype=np.float64)
    return lam**2 * np.log(np.maximum(L / (tau + 1.0), 1.0))


def _stationary_from_normals(zr: torch.Tensor, zi: torch.Tensor,
                             sqrt_eig: torch.Tensor, n: int) -> torch.Tensor:
    """``batch`` stationary Gaussian series of length ``n`` from i.i.d.
    unit normals ``zr, zi (batch, M)``: ``x = Re(ifft(sqrt(eig) * (zr + i
    zi))) * sqrt(M)`` has exactly the embedded covariance
    ``Cov(x_i, x_j) = (1/M) sum_k eig_k cos(2π(i-j)k/M)``."""
    m = sqrt_eig.shape[0]
    z = torch.complex(zr, zi) * sqrt_eig
    return (torch.fft.ifft(z, dim=-1).real * math.sqrt(m))[:, :n]


def _sample_stationary(generator: torch.Generator, sqrt_eig: torch.Tensor,
                       n: int, batch: int) -> torch.Tensor:
    m = sqrt_eig.shape[0]
    zr = torch.randn((batch, m), generator=generator, device=sqrt_eig.device)
    zi = torch.randn((batch, m), generator=generator, device=sqrt_eig.device)
    return _stationary_from_normals(zr, zi, sqrt_eig, n)


def _mrw_lnx(generator: torch.Generator, sq_eps: torch.Tensor,
             sq_om: torch.Tensor, mean_om: float, n: int,
             batch: int) -> torch.Tensor:
    """``(batch, n + 1)`` log-prices starting at 0."""
    eps = _sample_stationary(generator, sq_eps, n, batch)
    om = _sample_stationary(generator, sq_om, n, batch) + mean_om
    dx = eps * torch.exp(om)
    return torch.cat([torch.zeros_like(dx[:, :1]), torch.cumsum(dx, dim=-1)],
                     dim=-1)


class MRWGenerator:
    """Generate (and disk-cache) multifractal random walk log-prices.

    :param T: number of log-price samples per trajectory (T-1 increments)
    :param H: Hurst exponent of the Gaussian component
    :param lam: intermittency ``lambda`` of the log-correlated field
    :param cache_path: directory for the on-disk cache (``None`` = no cache)
    :param L: correlation length of the volatility field (default ``T-1``)
    :param sigma: scale of the finest-resolution increments
    :param seed: seed of the ``torch.Generator`` every draw comes from
    :param device: where the samples are drawn and returned: ``"cuda"``
        (default; raises without a card) or ``"cpu"``
    """

    def __init__(
        self,
        T: int,
        H: float = 0.5,
        lam: float = 0.2,
        cache_path: Optional[Union[Path, str]] = None,
        L: Optional[int] = None,
        sigma: float = 0.0126,  # ~20% annualized at daily resolution
        seed: int = 0,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        self.T = int(T)
        self.H = float(H)
        self.lam = float(lam)
        self.L = int(L) if L is not None else self.T - 1
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.cache_path = Path(cache_path) if cache_path is not None else None
        self.device = resolve_device(device)

        n = self.T - 1
        self._sq_eps = torch.as_tensor(
            _circulant_sqrt_spectrum(_fgn_cov(n, self.H, self.sigma)),
            dtype=torch.float32, device=self.device)
        om_cov = _omega_cov(n, self.lam, self.L)
        self._sq_om = torch.as_tensor(_circulant_sqrt_spectrum(om_cov),
                                      dtype=torch.float32, device=self.device)
        # E[exp(2 omega)] = 1  =>  mean = -Var(omega)
        self._mean_om = float(np.float32(-om_cov[0]))

    @property
    def cache_dir(self) -> Optional[Path]:
        if self.cache_path is None:
            return None
        tag = (
            f"MRW_T{self.T}_H{self.H:g}_la{self.lam:g}_L{self.L}"
            f"_sig{self.sigma:g}_seed{self.seed}"
        ).replace(".", "_")
        return self.cache_path / tag

    def generate(self, R: int, batch: int = 2048) -> torch.Tensor:
        """``R`` trajectories of log-prices, float32 ``(R, 1, T)`` on the
        generator's device. Every batch draws ``batch`` rows, so the first
        rows do not depend on ``R``."""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        out = torch.empty((R, 1, self.T), dtype=torch.float32,
                          device=self.device)
        for r0 in range(0, R, batch):
            lnx = _mrw_lnx(generator, self._sq_eps, self._sq_om,
                           self._mean_om, self.T - 1, batch)
            out[r0 : r0 + batch, 0] = lnx[: R - r0]
        return out

    def load(self, R: int) -> torch.Tensor:
        """``R`` trajectories from the cache, generating (and caching) them
        if it holds fewer."""
        cdir = self.cache_dir
        if cdir is None:
            return self.generate(R)
        cdir.mkdir(parents=True, exist_ok=True)
        fpath = cdir / "trajectories.npy"
        if fpath.exists():
            cached = np.load(fpath, mmap_mode="r")
            if cached.shape[0] >= R:
                return torch.from_numpy(np.array(cached[:R])).to(self.device)
        data = self.generate(R)
        np.save(fpath, as_numpy(data))
        return data
