"""Analytic dyadic wavelet filter bank, defined in the Fourier domain.

Port of :mod:`shadowing_tpu.models.scattering.wavelets`, a copy of its numpy
code: the two packages build the same filters bit for bit (importing the
JAX module would import JAX). Filters are built once on the host and
applied by FFT.

The mother wavelet is an *analytic* Morlet: a Gaussian bump centred at
``xi = 3*pi/4`` with a correction term cancelling the DC response, truncated
to positive frequencies (strict analyticity makes the modulus ``|W_j x|`` a
true envelope). Scale ``j`` dilates by ``2**j``; a Gaussian low-pass closes
the Littlewood-Paley sum.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

XI = 3.0 * np.pi / 4.0
#: bandwidth chosen so adjacent dyadic filters cross near half power
SIGMA0 = 0.6 * XI


@dataclass(frozen=True)
class FilterBank:
    """Fourier-domain filters for series of length ``T``.

    psi_hat: ``(J, T)`` analytic band-pass filters (float32, real-valued
        transfer functions on the fft frequency grid)
    phi_hat: ``(T,)`` low-pass at scale ``2**J``
    band_hi: per-scale upper support bin (exclusive): ``|psi_hat[j]|`` is
        below ``1e-6`` of its peak for all bins ``>= band_hi[j]``. The
        scattering statistics truncate their spectral contractions there
        (coarse scales occupy ~T/2**j bins). Rounded up to a multiple of
        128, as in the JAX package, so both banks are equal.
    """

    J: int
    T: int
    psi_hat: np.ndarray
    phi_hat: np.ndarray
    band_hi: tuple = ()


def _morlet_hat(omega: np.ndarray, xi: float, sigma: float) -> np.ndarray:
    """Analytic Morlet transfer function on the given frequency grid."""
    main = np.exp(-((omega - xi) ** 2) / (2 * sigma**2))
    # cancel the DC response, keep analyticity (positive frequencies only)
    corr = np.exp(-(xi**2) / (2 * sigma**2)) * np.exp(
        -(omega**2) / (2 * sigma**2)
    )
    h = (main - corr) * (omega > 0)
    return h


def build_filter_bank(T: int, J: int) -> FilterBank:
    """Dyadic analytic filters psi_j (j = 0..J-1; centre ``xi / 2**j``) and
    the closing low-pass phi_J, Littlewood-Paley normalised so that

        max_omega [ |phi(w)|^2 + 1/2 * sum_j |psi_j(w)|^2 ] = 1.
    """
    if 2**J > T:
        raise ValueError(f"J={J} too deep for T={T} (need 2**J <= T)")
    omega = 2 * np.pi * np.fft.fftfreq(T)  # in (-pi, pi]

    psi = np.stack(
        [_morlet_hat(omega * 2**j, XI, SIGMA0) for j in range(J)]
    )
    sigma_lp = XI / 2**J
    phi = np.exp(-(omega**2) / (2 * sigma_lp**2))

    # Littlewood-Paley renormalisation (on positive frequencies; the factor
    # 1/2 accounts for the analytic filters covering only half the axis)
    lp = np.abs(phi) ** 2 + 0.5 * (np.abs(psi) ** 2).sum(0)
    norm = np.sqrt(lp.max())
    psi = psi / norm
    phi = phi / norm

    psi = psi.astype(np.float32)
    half = T // 2 + 1
    band_hi = []
    for j in range(J):
        nz = np.flatnonzero(np.abs(psi[j, :half]) > 1e-6 * np.abs(psi[j]).max())
        hi = int(nz[-1]) + 1 if nz.size else 1
        band_hi.append(min(half, -(-hi // 128) * 128))
    return FilterBank(
        J=J,
        T=T,
        psi_hat=psi,
        phi_hat=phi.astype(np.float32),
        band_hi=tuple(band_hi),
    )
