"""Black-Scholes pricing and implied volatility (vectorised).

Port of :mod:`shadowing_tpu.pricing.black_scholes`: inverts Hedged-Monte-
Carlo prices into implied volatilities by bisection.
"""
from __future__ import annotations

import math

import torch

SIGMA_LO = 1e-4
SIGMA_HI = 5.0


def _f32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _norm_cdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


def bs_call_price(spot, strike, tau, sigma, r=0.0):
    """Black-Scholes European call. ``tau`` in years, ``sigma`` annualised."""
    like = next((a for a in (spot, strike, tau, sigma)
                 if isinstance(a, torch.Tensor)), None)
    spot, strike, tau, sigma = (_f32(a, like) for a in (spot, strike, tau, sigma))
    sig_sqrt = torch.clamp(sigma, min=1e-12) * torch.sqrt(torch.clamp(tau, min=1e-12))
    d1 = (torch.log(spot / strike) + (r + 0.5 * sigma**2) * tau) / sig_sqrt
    d2 = d1 - sig_sqrt
    return spot * _norm_cdf(d1) - strike * torch.exp(-r * tau) * _norm_cdf(d2)


def bs_implied_vol(price, spot, strike, tau, r=0.0, n_iter: int = 80):
    """Implied volatility by bisection.

    Prices outside the solvable bracket — below the ``SIGMA_LO`` price or
    above the ``SIGMA_HI`` price — return NaN rather than a railed bound."""
    like = next((a for a in (price, spot, strike, tau)
                 if isinstance(a, torch.Tensor)), None)
    price, spot, strike, tau = (_f32(a, like) for a in (price, spot, strike, tau))
    shape = torch.broadcast_shapes(price.shape, spot.shape, strike.shape,
                                   tau.shape)
    lo = torch.full(shape, SIGMA_LO, device=price.device)
    hi = torch.full(shape, SIGMA_HI, device=price.device)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_low = bs_call_price(spot, strike, tau, mid, r) < price
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    # f32 guard band: boundary prices stay solvable despite rounding skew
    tol = 1e-6 * spot
    valid = ((price >= bs_call_price(spot, strike, tau, SIGMA_LO, r) - tol)
             & (price <= bs_call_price(spot, strike, tau, SIGMA_HI, r) + tol))
    return torch.where(valid, 0.5 * (lo + hi),
                       torch.tensor(float("nan"), device=price.device))
