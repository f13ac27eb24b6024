"""Inputs of a run, made from ``--seed``: the dataset on the device and the
bundled S&P-like series on the host.

The MRW sampler is a frozen copy of the circulant-embedding (Davies-Harte)
construction of ``shadowing_tpu_torch.models.mrw``: later changes to the
port's generator do not change the benchmark's data. Every draw comes from
a ``torch.Generator`` on the device, seeded from ``--seed`` and a tag, so
the same seed gives the same data, bit for bit, on the same device.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

SNP_PATH = Path(__file__).resolve().parent / "data" / "snp_daily.npz"
#: rows drawn per batch by the MRW sampler (the port's default batch)
MRW_BATCH = 2048


def sub_seed(seed: int, tag: str) -> int:
    """A 64-bit seed for one use (``tag``) of the run's ``--seed``."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def snp_returns() -> np.ndarray:
    """The bundled S&P-like daily log-returns, float64 ``(9124,)``."""
    with np.load(SNP_PATH) as bundle:
        return np.asarray(bundle["dlnx"], dtype=np.float64)


def _circulant_sqrt_spectrum(cov_row: np.ndarray) -> np.ndarray:
    row = np.concatenate([cov_row, cov_row[-2:0:-1]])
    return np.sqrt(np.maximum(np.fft.fft(row).real, 0.0))


def _fgn_cov(n: int, H: float, sigma: float) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.5 * sigma**2 * (np.abs(k + 1) ** (2 * H) - 2 * np.abs(k) ** (2 * H)
                             + np.abs(k - 1) ** (2 * H))


def _omega_cov(n: int, lam: float, L: int) -> np.ndarray:
    tau = np.arange(n, dtype=np.float64)
    return lam**2 * np.log(np.maximum(L / (tau + 1.0), 1.0))


def _stationary(gen: torch.Generator, sqrt_eig: torch.Tensor, n: int,
                batch: int) -> torch.Tensor:
    m = sqrt_eig.shape[0]
    zr = torch.randn((batch, m), generator=gen, device=sqrt_eig.device)
    zi = torch.randn((batch, m), generator=gen, device=sqrt_eig.device)
    z = torch.complex(zr, zi) * sqrt_eig
    return (torch.fft.ifft(z, dim=-1).real * math.sqrt(m))[:, :n]


def mrw_returns(spec: dict, seed: int, device) -> torch.Tensor:
    """MRW log-returns ``(R, 1, T - 1)`` float32: ``T`` log-prices per
    trajectory, increments ``eps * exp(omega)`` with fractional Gaussian
    ``eps`` (Hurst ``H``, scale ``sigma``) and a log-correlated ``omega``
    (intermittency ``lam``, correlation length ``T - 1``)."""
    R, n = int(spec["R"]), int(spec["T"]) - 1
    sq_eps = torch.as_tensor(_circulant_sqrt_spectrum(
        _fgn_cov(n, spec["H"], spec["sigma"])), dtype=torch.float32,
        device=device)
    om_cov = _omega_cov(n, spec["lam"], n)
    sq_om = torch.as_tensor(_circulant_sqrt_spectrum(om_cov),
                            dtype=torch.float32, device=device)
    mean_om = float(np.float32(-om_cov[0]))     # E[exp(2 omega)] = 1
    gen = generator(seed, "dataset", device)
    out = torch.empty((R, 1, n), dtype=torch.float32, device=device)
    for r0 in range(0, R, MRW_BATCH):
        eps = _stationary(gen, sq_eps, n, MRW_BATCH)
        om = _stationary(gen, sq_om, n, MRW_BATCH) + mean_om
        out[r0 : r0 + MRW_BATCH, 0] = (eps * torch.exp(om))[: R - r0]
    return out


def normal_dataset(spec: dict, seed: int, device) -> torch.Tensor:
    """Standard normal float32 ``(R, C, T)`` times ``std``, in one call."""
    gen = generator(seed, "dataset", device)
    shape = (int(spec["R"]), int(spec.get("C", 1)), int(spec["T"]))
    data = torch.randn(shape, generator=gen, device=device)
    std = float(spec.get("std", 1.0))
    return data if std == 1.0 else data.mul_(std)


DATASETS = {"mrw": mrw_returns, "normal": normal_dataset}


def dataset(spec: dict, seed: int, device) -> torch.Tensor:
    """The configuration's dataset ``(R, C, T)`` on ``device``."""
    return DATASETS[spec["kind"]](spec, seed, device)

