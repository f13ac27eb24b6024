"""Hedged Monte Carlo call prices and their implied-volatility smile, from
the definitions, one context, one maturity and one time step at a time.

The method is Potters, Bouchaud and Sestovic (2001): going back in time,
the price at each step is the regression of the next step's price on the
current one, jointly with a hedge, minimising the hedged variance. The
port documents these choices, and the reference follows them:

- The paths are the k winners' futures, ``S_t = x_init exp(cumsum r)``,
  with ``x_init`` = 100 and rate ``r`` (0 in the benchmark); ``S~_t =
  e^(-r t dt) S_t``. Under the Softmax measure each winner weighs ``w_n
  ∝ exp(-d_n^2 / (2 eta^2))`` (the paper weighs paths equally).
- Strikes are ``K = S_0 exp(M sigma_T sqrt(tau))``, ``tau = T / 252``,
  ``sigma_T^2 = sum_n w_n RV_n``, where ``RV_n`` is the sum of the first
  ``T`` squared log-returns over ``tau``.
- For ``t = T-1 .. 1``: ``(a, b)`` minimises ``sum_n w_n (C_{t+1} - sum_j
  a_j phi_j(S_t) - sum_j b_j phi_j(S_t) dS~_t)^2 + 1e-9 |(a, b)|^2`` over
  ``m = 12`` hat functions ``phi_j`` on knots of step ``t``, and ``C_t =
  sum_j a_j phi_j(S_t)``, from ``C_T = e^(-r T dt) (S_T - K)^+``. The
  paper names no basis and no ridge; the ridge keeps a system whose weights
  sit on a few paths solvable.
- The knots are the quantiles at ``linspace(0, 1, m)`` of the step's
  prices over every path (not weighted): empirical, interpolated
  linearly, for ``N < 2048`` paths; else those of the lognormal with the
  step's log-price mean and standard deviation (at least 1e-7), with the
  grid's ends clipped to ``max(1 / (2N), 1e-6)``. Each set is made
  strictly increasing by adding ``j 1e-6 (knot_max - knot_min + 1)`` to
  knot ``j``. A hat function is constant beyond the outer knots.
- At ``t = 0`` every path starts at ``S_0``, so the last step regresses
  ``C_1`` on ``(1, dS~_0)`` alone (same ridge); the price is the constant.
- The implied volatility inverts Black-Scholes by bisection between 1e-4
  and 5; a price outside the prices at those two volatilities has none
  (NaN).

:func:`smile` is the whole product for one context. Every function takes
an :class:`~benchmark.reference.precision.Arith`: ``FLOAT64`` is the
reference's answer; the control computes in float32 with TF32 products
(``TF32``). It imports neither JAX nor either package, uses no kernel,
cache or batch over contexts, and turns TF32 off in cuBLAS and cuDNN
around its work (:func:`~benchmark.reference.precision.exact_products`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import FLOAT64, Arith, exact_products
from benchmark.reference.predict import softmax_weights

ANNUALIZATION = 252
RIDGE = 1e-9
N_BASIS = 12
#: paths from which the knots are the lognormal-moment quantiles
MOMENT_FROM = 2048
SIGMA_LO, SIGMA_HI = 1e-4, 5.0
BISECTIONS = 100


def price_paths(future, x_init: float, arith: Arith = FLOAT64) -> torch.Tensor:
    """``(N, h + 1)`` prices ``x_init exp(cumsum r)`` of the returns
    ``future (N, h)``, starting at ``x_init``."""
    r = torch.as_tensor(np.asarray(future), dtype=arith.torch_dtype)
    ln = torch.cat([torch.zeros_like(r[:, :1]), torch.cumsum(r, dim=1)], dim=1)
    return x_init * torch.exp(ln)


def knots(prices: torch.Tensor) -> torch.Tensor:
    """The ``N_BASIS`` strictly increasing knots of one step's prices
    ``(N,)``."""
    N, m = prices.shape[0], N_BASIS
    grid = torch.linspace(0.0, 1.0, m, dtype=prices.dtype)
    if N < MOMENT_FROM:
        kn = torch.quantile(prices, grid, interpolation="linear")
    else:
        ln = torch.log(torch.clamp(prices, min=1e-30))
        sig = torch.clamp(ln.std(correction=0), min=1e-7)
        eps = max(1.0 / (2 * N), 1e-6)
        kn = torch.exp(ln.mean() + sig * torch.special.ndtri(
            torch.clamp(grid, eps, 1.0 - eps)))
    return kn + torch.arange(m, dtype=prices.dtype) * 1e-6 * (kn[-1] - kn[0] + 1.0)


def hat_basis(s: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
    """``(N, m)`` values of the hat functions on the knots ``kn`` at ``s``:
    ``phi_j`` is 1 at knot ``j``, 0 at the knots beside it, linear between,
    and constant beyond the outer knots."""
    m = kn.shape[0]
    s = torch.clamp(s, kn[0], kn[-1])
    one = torch.ones_like(s)
    cols = []
    for j in range(m):
        up = (s - kn[j - 1]) / (kn[j] - kn[j - 1]) if j > 0 else one
        down = (kn[j + 1] - s) / (kn[j + 1] - kn[j]) if j < m - 1 else one
        cols.append(torch.clamp(torch.minimum(up, down), 0.0, 1.0))
    return torch.stack(cols, dim=1)


def _regress(A: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
             arith: Arith) -> torch.Tensor:
    """``argmin_c sum_n w_n |y_n - A_n c|^2 + RIDGE |c|^2`` per column of
    ``y (N, nK)``, by its normal equations."""
    sw = torch.sqrt(w)[:, None]
    Aw, yw = A * sw, y * sw
    gram = arith.mm(Aw.T, Aw) + RIDGE * torch.eye(A.shape[1], dtype=A.dtype)
    return torch.linalg.solve(gram, arith.mm(Aw.T, yw))


def hmc_prices(paths: torch.Tensor, weights: torch.Tensor,
               strikes: torch.Tensor, discount: float = 1.0,
               arith: Arith = FLOAT64) -> torch.Tensor:
    """``(nK,)`` Hedged-MC call prices at ``t = 0`` of the paths ``(N, T +
    1)`` under the measure ``weights (N,)`` (summing to 1)."""
    dt = arith.torch_dtype
    paths, weights, strikes = (torch.as_tensor(a).to(dt)
                               for a in (paths, weights, strikes))
    T = paths.shape[1] - 1
    disc = torch.tensor(discount, dtype=dt) ** torch.arange(T + 1, dtype=dt)
    s_tilde = paths * disc
    c = torch.clamp(paths[:, T, None] - strikes[None, :], min=0.0) * disc[T]
    for t in range(T - 1, 0, -1):
        phi = hat_basis(paths[:, t], knots(paths[:, t]))
        ds = s_tilde[:, t + 1] - s_tilde[:, t]
        coef = _regress(torch.cat([phi, phi * ds[:, None]], dim=1), weights,
                        c, arith)
        c = arith.mm(phi, coef[:N_BASIS])
    ds0 = s_tilde[:, 1] - s_tilde[:, 0]
    A0 = torch.stack([torch.ones_like(ds0), ds0], dim=1)
    return _regress(A0, weights, c, arith)[0]


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def bs_call(spot, strike, tau: float, sigma, r: float = 0.0) -> torch.Tensor:
    """The Black-Scholes call price."""
    st = sigma * math.sqrt(tau)
    d1 = (torch.log(spot / strike) + (r + 0.5 * sigma ** 2) * tau) / st
    return spot * _norm_cdf(d1) - strike * math.exp(-r * tau) * _norm_cdf(d1 - st)


def room(price: torch.Tensor, spot: float, strike: torch.Tensor, tau: float,
         r: float = 0.0) -> torch.Tensor:
    """How far each price lies inside the prices that have a vol (those at
    ``SIGMA_LO`` and ``SIGMA_HI``); negative outside."""
    price, strike = price.to(torch.float64), strike.to(torch.float64)
    spot = torch.full_like(strike, float(spot))
    return torch.minimum(
        price - bs_call(spot, strike, tau, spot.new_tensor(SIGMA_LO), r),
        bs_call(spot, strike, tau, spot.new_tensor(SIGMA_HI), r) - price)


def implied_vol(price: torch.Tensor, spot: float, strike: torch.Tensor,
                tau: float, r: float = 0.0) -> torch.Tensor:
    """The volatility whose Black-Scholes price is ``price``, by bisection
    on ``[SIGMA_LO, SIGMA_HI]``; NaN for a price outside the prices there."""
    price, strike = price.to(torch.float64), strike.to(torch.float64)
    s = torch.full_like(strike, float(spot))
    lo = torch.full_like(strike, SIGMA_LO)
    hi = torch.full_like(strike, SIGMA_HI)
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        low = bs_call(s, strike, tau, mid, r) < price
        lo, hi = torch.where(low, mid, lo), torch.where(low, hi, mid)
    return torch.where(room(price, spot, strike, tau, r) >= 0, 0.5 * (lo + hi),
                       torch.full_like(lo, math.nan))


def smile_of_paths(paths, weights, Ts, Ms, r: float = 0.0,
                   arith: Arith = FLOAT64) -> dict:
    """Strikes, prices and implied vols ``(nT, nM)`` and ``sigma_T (nT,)``
    of the price paths ``(N, h + 1)`` under ``weights (N,)``; and ``room
    (nT, nM)`` of each price (:func:`room`)."""
    dt = arith.torch_dtype
    paths = torch.as_tensor(paths).to(dt)
    weights = torch.as_tensor(weights).to(dt)
    weights = weights / weights.sum()
    Ms = torch.as_tensor(np.asarray(Ms, dtype=np.float64)).to(dt)
    spot = float(paths[0, 0])
    rets = torch.diff(torch.log(paths), dim=1)
    out = {"strikes": [], "prices": [], "vols": [], "sigma": [], "room": []}
    with exact_products():
        for T in (int(T) for T in Ts):
            tau = T / ANNUALIZATION
            rv = arith.sumsq(rets[:, :T]) / tau
            sigma = torch.sqrt(arith.wsum(weights, rv, axis=0))
            strikes = spot * torch.exp(Ms * sigma * math.sqrt(tau))
            prices = hmc_prices(paths[:, : T + 1], weights, strikes,
                                math.exp(-r / ANNUALIZATION), arith)
            out["strikes"].append(strikes)
            out["prices"].append(prices)
            out["vols"].append(implied_vol(prices, spot, strikes, tau, r))
            out["sigma"].append(sigma)
            out["room"].append(room(prices, spot, strikes, tau, r))
    return {key: torch.stack(v).to(torch.float64).numpy()
            for key, v in out.items()}


def smile(dist, future, Ts, Ms, eta: float, x_init: float = 100.0,
          r: float = 0.0, arith: Arith = FLOAT64) -> dict:
    """The smile of one context from its k winners: distances ``(k,)``
    and future returns ``(k, h)``."""
    w = softmax_weights(np.asarray(dist, np.float64)[None], eta)[0]
    return smile_of_paths(price_paths(future, x_init, arith), arith.q(w),
                          Ts, Ms, r, arith)


def effective_paths(dist, eta: float) -> float:
    """``1 / sum w^2`` of the Softmax weights of the distances ``(k,)``."""
    w = softmax_weights(np.asarray(dist, np.float64)[None], eta)[0]
    return float(1.0 / (w ** 2).sum())
