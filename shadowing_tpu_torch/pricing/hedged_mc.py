"""Hedged Monte Carlo option pricing (Potters, Bouchaud, Sestovic 2001).

Port of :mod:`shadowing_tpu.pricing.hedged_mc`: price options on a set of
(shadowing) price paths by backward induction with quadratic hedging, then
express the prices as an implied-volatility smile over a rescaled
log-moneyness grid, optionally under a distance-weighted path measure.

For each maturity the regression runs backwards over time; both the price
and the hedge are expanded on a piecewise-linear hat basis over per-step
knots, so each step is one ``(2m x 2m)`` weighted normal-equation solve
against an ``(N x n_strikes)`` target block, in float64 whatever the
dtype of the paths (:func:`_backward` says why; unchecked, as in the JAX
package: a singular system yields non-finite prices and NaN vols, not an
error). On a CPU tensor the induction loops over time in PyTorch; on the
card one kernel (``ops/smile.py``, ``csrc/hedged_mc.cu``) runs the
inductions and the Black-Scholes inversions of every context and maturity.
The public functions take the paths in float32; the engine hands
:func:`_smiles` float64 paths. A :class:`Smile`'s arrays are float32, its
strikes float64. Every function takes a leading batch axis of path sets
(one per context) written out.

Strikes are ``K = S0 exp(M sigma_T sqrt(tau))`` with ``sigma_T`` the
(weighted) RMS realized volatility of the paths to maturity ``T``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array, as_numpy
from shadowing_tpu_torch.ops import smile as smile_ops
from shadowing_tpu_torch.pricing.black_scholes import bs_implied_vol
from shadowing_tpu_torch.stats.proba import DiscreteProba
from shadowing_tpu_torch.stats.realized import ANNUALIZATION
from shadowing_tpu_torch.utils.profiling import count, span

_RIDGE = 1e-9


def _hat_basis(s: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear hat functions with constant extrapolation tails.

    :param s: ``(..., N)`` evaluation points (clipped to the knot range)
    :param knots: ``(..., m)`` increasing knots, same leading axes as ``s``
    :return: ``(..., N, m)`` basis values (rows sum to 1)
    """
    m = knots.shape[-1]
    s = torch.minimum(torch.maximum(s, knots[..., :1]), knots[..., -1:])
    idx = (torch.searchsorted(knots.contiguous(), s.contiguous(), right=True)
           - 1).clamp(0, m - 2)
    left = torch.gather(knots, -1, idx)
    right = torch.gather(knots, -1, idx + 1)
    frac = (s - left) / torch.clamp(right - left, min=1e-12)
    b = torch.zeros(s.shape + (m,), dtype=s.dtype, device=s.device)
    b.scatter_(-1, idx[..., None], (1.0 - frac)[..., None])
    b.scatter_add_(-1, (idx + 1)[..., None], frac[..., None])
    return b


def _quantile_linear(a: torch.Tensor, q: torch.Tensor, dim: int) -> torch.Tensor:
    """``numpy.quantile(a, q, axis=dim)`` with linear interpolation; the
    quantile axis replaces ``dim`` (no size limit, unlike ``torch.quantile``)."""
    srt = torch.sort(a, dim=dim).values.movedim(dim, -1)      # (..., n)
    n = srt.shape[-1]
    pos = q * (n - 1)
    low = torch.floor(pos)
    hw = pos - low
    lo = low.long().clamp(0, n - 1)
    hi = torch.ceil(pos).long().clamp(0, n - 1)
    return srt[..., lo] * (1.0 - hw) + srt[..., hi] * hw       # (..., len(q))


def _regression_knots(paths: torch.Tensor, n_basis: int,
                      knots: str = "auto") -> Optional[torch.Tensor]:
    """Per-step regression knots ``(B, T-1, m)`` float64 of the price paths
    ``(B, N, T+1)`` at steps 1 .. T-1 (``None`` for ``T < 2``), all steps at
    once: exact empirical quantiles for small path sets (the moment grid can
    leave hat cells empty there), else the lognormal-moment approximation of
    the same quantile grid (sort-free, exact in distribution for lognormal
    steps). ``knots`` forces a branch: ``"empirical"`` or ``"moment"``."""
    B, N, T1 = paths.shape
    T = T1 - 1
    if T < 2:
        return None
    paths = paths.to(torch.float64)
    grid = torch.linspace(0.0, 1.0, n_basis, dtype=torch.float64,
                          device=paths.device)
    use_empirical = N < 2048 if knots == "auto" else knots == "empirical"
    if use_empirical:
        return _quantile_linear(paths[:, :, 1:T], grid, dim=1)  # (B, T-1, m)
    ln_s = torch.log(torch.clamp(paths[:, :, 1:T], min=1e-30))  # (B, N, T-1)
    mu_t = ln_s.mean(dim=1)
    sig_t = torch.clamp(ln_s.std(dim=1, correction=0), min=1e-7)
    eps = max(1.0 / (2 * N), 1e-6)
    g = torch.special.ndtri(torch.clamp(grid, eps, 1.0 - eps))
    return torch.exp(mu_t[..., None] + sig_t[..., None] * g)


def _backward(
    paths: torch.Tensor,     # (B, N, T+1) raw prices, common S0 per row
    weights: torch.Tensor,   # (B, N) path measure, rows sum to 1
    strikes: torch.Tensor,   # (B, nK)
    discount: float,         # e^{-r dt}
    knots_all: Optional[torch.Tensor],   # (B, >= T-1, m), _regression_knots
    n_basis: int,
) -> torch.Tensor:           # (B, nK) option prices at t=0, dtype of paths
    """The backward induction of one maturity.

    Every step's weighted normal equations are formed and solved in
    float64, whatever the dtype of the inputs. Under a Softmax measure at a
    small bandwidth the weights sit on one or two paths: the normal matrix
    then has a few eigenvalues of order one and the rest at the ridge,
    1e-9, below float32's rounding of the order-one entries (6e-8), so a
    float32 solve returns prices that are off by up to several times the
    spot. In float64 the ridge stands far above the rounding and the solve
    gives the answer the ridge defines. A ridge scaled to the weights would
    define another answer, so the ridge stays as it is."""
    out_dtype = paths.dtype
    paths, weights, strikes = (a.to(torch.float64)
                               for a in (paths, weights, strikes))
    B, N, T1 = paths.shape
    T = T1 - 1
    dev = paths.device
    disc_t = torch.tensor(discount, dtype=torch.float64, device=dev) ** \
        torch.arange(T1, device=dev)                           # (T+1,)
    s_tilde = paths * disc_t                                   # discounted
    payoff = torch.clamp(paths[:, :, -1, None] - strikes[:, None, :], min=0.0)
    c_next = payoff * disc_t[-1]                               # (B, N, nK)
    w_sqrt = torch.sqrt(weights)[:, :, None]                   # (B, N, 1)
    eye = torch.eye(2 * n_basis, dtype=torch.float64, device=dev)
    ramp = torch.arange(n_basis, dtype=torch.float64, device=dev) * 1e-6

    # t = T-1 .. 1 (the t=0 step is degenerate: all S_0 equal)
    for t in range(T - 1, 0, -1):
        kn = knots_all[:, t - 1]                               # (B, m)
        # strictly increasing knots (ties when sig_t ~ 0 near t=0)
        kn = kn + ramp * (kn[:, -1:] - kn[:, :1] + 1.0)
        ds = s_tilde[:, :, t + 1] - s_tilde[:, :, t]           # (B, N)
        basis = _hat_basis(paths[:, :, t], kn)                 # (B, N, m)
        Aw = torch.cat([basis, basis * ds[..., None]], dim=-1) * w_sqrt
        gram = Aw.transpose(1, 2) @ Aw + _RIDGE * eye
        rhs = Aw.transpose(1, 2) @ (c_next * w_sqrt)           # (B, 2m, nK)
        coef = torch.linalg.solve_ex(gram, rhs).result
        c_next = basis @ coef[:, :n_basis]                     # (B, N, nK)

    # final step: scalar C_0 and scalar hedge phi_0
    ds0 = s_tilde[:, :, 1] - s_tilde[:, :, 0]
    A0w = torch.stack([torch.ones_like(ds0), ds0], dim=-1) * w_sqrt
    gram0 = A0w.transpose(1, 2) @ A0w + _RIDGE * eye[:2, :2]
    rhs0 = A0w.transpose(1, 2) @ (c_next * w_sqrt)
    return torch.linalg.solve_ex(gram0, rhs0).result[:, 0].to(out_dtype)


def _hmc_prices(
    paths: torch.Tensor,     # (B, N, T+1) raw prices, common S0 per row
    weights: torch.Tensor,   # (B, N) path measure, rows sum to 1
    strikes: torch.Tensor,   # (B, nK)
    discount: float,         # e^{-r dt}
    n_basis: int,
    knots: str = "auto",     # "auto" | "empirical" | "moment"
) -> torch.Tensor:           # (B, nK) option prices at t=0
    """Hedged-MC call prices for a batch of path sets (unbatched
    ``(N, T+1)`` / ``(N,)`` / ``(nK,)`` inputs are accepted too)."""
    if paths.ndim == 2:
        return _hmc_prices(paths[None], weights[None], strikes[None],
                           discount, n_basis, knots)[0]
    return _backward(paths, weights, strikes, discount,
                     _regression_knots(paths, n_basis, knots), n_basis)


def _smile_core(xj, weights, Ms, s0, r, Ts, n_basis):
    """Strikes / HMC prices / implied vols / reference vols for every
    maturity: ``(B, nT, nM)`` x 3 and ``(B, nT)``. In phases over every
    maturity, each a span: the strikes and regression knots, the backward
    inductions, the Black-Scholes inversions. On the card one kernel
    (``ops/smile.py``) does the last two, inside ``psmc.smile.regress``."""
    dt = 1.0 / ANNUALIZATION
    discount = math.exp(-r * dt)
    count("smile_solves", xj.shape[0] * sum(Ts))
    with span("psmc.smile.knots"):
        dlnx = torch.diff(torch.log(xj), dim=-1)
        strikes_all, sig_all = [], []
        for T in Ts:
            tau = T * dt
            rv = (dlnx[..., :T] ** 2).sum(dim=-1) / tau        # (B, N)
            sigma_T = torch.sqrt((weights * rv).sum(dim=-1))   # (B,)
            strikes_all.append(s0[:, None] * torch.exp(
                Ms[None] * sigma_T[:, None] * math.sqrt(tau)))
            sig_all.append(sigma_T)
        # the knots of step t are those of every maturity past t
        knots = _regression_knots(xj[..., : max(Ts) + 1], n_basis)
    strikes, sig = torch.stack(strikes_all, 1), torch.stack(sig_all, 1)
    if xj.device.type == "cuda":
        with span("psmc.smile.regress"):
            prices, vols = smile_ops.hedged_mc_smile(xj, weights, strikes,
                                                     knots, Ts, discount, r)
        return strikes, prices.to(xj.dtype), vols, sig
    with span("psmc.smile.regress"):
        prices_all = [_backward(xj[..., : T + 1], weights, strikes_all[i],
                                discount, knots, n_basis)
                      for i, T in enumerate(Ts)]
    with span("psmc.smile.vols"):
        vols_all = [bs_implied_vol(prices, s0[:, None], strikes_all[i],
                                   T * dt, r)
                    for i, (T, prices) in enumerate(zip(Ts, prices_all))]
    return (strikes, torch.stack(prices_all, 1), torch.stack(vols_all, 1),
            sig)


@dataclass
class Smile:
    """Implied-volatility smile over maturities x rescaled log-moneyness."""

    Ts: np.ndarray                 # maturities, trading days
    Ms: np.ndarray                 # rescaled log-moneyness grid
    strikes: np.ndarray            # (nT, nM)
    prices: np.ndarray             # (nT, nM) option prices
    vols: np.ndarray               # (nT, nM) implied vols, annualised
    sigma_ref: np.ndarray          # (nT,) vol used to rescale moneyness
    spot: float
    r: float = 0.0

    def plot(self, ax=None, color=None, rescale: bool = True,
             legend: bool = False):
        """Plot one implied-vol line per maturity (x-axis: ``M`` if
        ``rescale`` else ``ln(K/S0)``)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(4, 3))
        n = len(self.Ts)
        for i, T in enumerate(self.Ts):
            x = self.Ms if rescale else np.log(self.strikes[i] / self.spot)
            ax.plot(x, self.vols[i], marker="o", ms=3, color=color,
                    alpha=1.0 - 0.6 * i / max(n - 1, 1), label=rf"$T={int(T)}$")
        ax.set_xlabel(r"$\mathcal{M}$" if rescale else r"$\ln(K/S_0)$")
        ax.set_ylabel(r"implied vol")
        if legend:
            ax.legend(fontsize=8)
        return ax


def _smiles(xj, w, Ts, Ms, r, n_basis) -> list:
    Ts = np.asarray(list(Ts), dtype=np.int64)
    Ms_np = np.asarray(list(Ms), dtype=np.float64)
    if Ts.max() > xj.shape[-1] - 1:
        raise ValueError(
            f"max maturity {Ts.max()} exceeds path length {xj.shape[-1] - 1}"
        )
    s0 = xj[:, 0, 0]
    count("smile_contexts", xj.shape[0])
    out = _smile_core(xj, w, torch.as_tensor(Ms_np, dtype=xj.dtype,
                                             device=xj.device),
                      s0, float(r), tuple(int(t) for t in Ts), n_basis)
    strikes, prices, vols, sig, s0 = (as_numpy(a) for a in (*out, s0))
    strikes = strikes.astype(np.float64)
    prices, vols, sig = (a.astype(np.float32) for a in (prices, vols, sig))
    return [
        Smile(Ts=Ts, Ms=Ms_np, strikes=strikes[b], prices=prices[b],
              vols=vols[b], sigma_ref=sig[b], spot=float(s0[b]), r=float(r))
        for b in range(xj.shape[0])
    ]


def _as_paths(x: Array) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def compute_smile(
    x: Array,
    Ts: Sequence[int],
    Ms: Sequence[float],
    r: float = 0.0,
    ave: Optional[DiscreteProba] = None,
    n_basis: int = 12,
) -> Smile:
    """Hedged-Monte-Carlo smile on ``(N, T+1)`` price paths sharing one
    first price ``S0``, under the path measure ``ave`` (``None`` = uniform).
    Runs on the device of ``x`` when it is a tensor; on the card
    ``n_basis`` is at most 84 (``ops/smile.py`` says why)."""
    xj = _as_paths(x)
    if xj.ndim != 2:
        raise ValueError(f"paths must be (N, T+1), got {tuple(xj.shape)}")
    first = as_numpy(xj[:, 0])
    if not np.allclose(first, first[0], rtol=1e-5):
        raise ValueError("all paths must share the same initial price S0")
    N = xj.shape[0]
    if ave is None:
        w = torch.full((N,), 1.0 / N, device=xj.device)
    else:
        w = ave.weights_like(torch.zeros((N,), device=xj.device), axis=0)
        w = (w / w.sum()).to(xj.device, torch.float32)
    return _smiles(xj[None], w[None], Ts, Ms, r, n_basis)[0]


def compute_smile_batch(
    x: Array,
    Ts: Sequence[int],
    Ms: Sequence[float],
    r: float = 0.0,
    weights: Optional[Array] = None,
    n_basis: int = 12,
    validate: bool = True,
) -> list:
    """Hedged-MC smiles for a batch of path sets ``(B, N, T+1)``, each row
    sharing its own initial price; ``weights`` are optional ``(B, N)`` path
    measures (rows need not be normalised). Returns a list of B
    :class:`Smile`; ``validate=False`` skips the common-S0 check. On the
    card ``n_basis`` is at most 84 (``ops/smile.py`` says why)."""
    xj = _as_paths(x)
    if xj.ndim != 3:
        raise ValueError(f"paths must be (B, N, T+1), got {tuple(xj.shape)}")
    B, N, _ = xj.shape
    if weights is None:
        w = torch.full((B, N), 1.0 / N, device=xj.device)
    else:
        w = (weights if isinstance(weights, torch.Tensor)
             else torch.as_tensor(np.asarray(weights)))
        w = w.to(xj.device, torch.float32)
        if tuple(w.shape) != (B, N):
            raise ValueError(f"weights must be (B, N)={B, N}, got "
                             f"{tuple(w.shape)}")
        w = w / w.sum(dim=1, keepdim=True)
    if validate:
        first = as_numpy(xj[:, :, 0])
        if not np.allclose(first, first[:, :1], rtol=1e-5):
            raise ValueError(
                "all paths of a batch row must share that row's initial price"
            )
    return _smiles(xj, w, Ts, Ms, r, n_basis)
