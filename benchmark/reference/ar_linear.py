"""The autoregressive linear volatility benchmark (Guyon and Lekeufack,
power-law kernels) that the backtest scores beside PSMC.

Per maturity ``T``, a least-squares fit of the future realized volatility
over ``T`` days on the features ``(1, <k1, r>, sqrt(<k2, r^2>))`` of the
``w`` past log-returns ``r``, over every span of ``w + 1 + T`` prices of the
training series (past and future share one price). ``k_i(tau) = (tau +
delta_i) ** -alpha_i`` over lags ``tau = (w - 1 .. 0) / 252`` years,
scaled to sum to 252. Predictions are returned as annualised variances.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.precision import Arith

ANNUALIZATION = 252
#: the published power-law kernel constants (per-year rates)
K1 = {"delta": 0.044, "alpha": 2.82}
K2 = {"delta": 0.025, "alpha": 1.86}


def power_law_kernel(w: int, delta: float, alpha: float) -> np.ndarray:
    taus = np.arange(w)[::-1] / ANNUALIZATION
    kern = (taus + delta) ** (-alpha)
    return kern * ANNUALIZATION / kern.sum()


def _features(r: np.ndarray, k1, k2, arith: Arith) -> np.ndarray:
    r = arith.q(r)
    R1 = arith.mm(r, k1)
    R2 = np.sqrt(arith.mm(r * r, k2))
    return np.stack([np.ones_like(R1), R1, R2], axis=-1)


def ar_linear(train: np.ndarray, contexts: np.ndarray, Ts, w: int,
              arith: Arith) -> np.ndarray:
    """``(len(contexts), len(Ts))`` predicted annualised variances of the
    contexts ``(n, w)`` (log-returns), fitted on the log-returns ``train``."""
    dt = arith.np_dtype
    lnx = np.concatenate([[0.0], np.cumsum(np.asarray(train, dtype=np.float64))])
    k1 = power_law_kernel(w, **K1).astype(dt)
    k2 = power_law_kernel(w, **K2).astype(dt)
    cols = []
    for T in Ts:
        span = w + 1 + int(T)
        n = lnx.size - span + 1
        spans = lnx[np.arange(n)[:, None] + np.arange(span)]
        past = np.diff(spans[:, : w + 1], axis=1).astype(dt)
        fut = np.diff(spans[:, w:], axis=1).astype(dt)
        vol = np.sqrt(arith.sumsq(fut) / dt(int(T) / ANNUALIZATION))
        X = _features(past, k1, k2, arith)
        coef = np.linalg.lstsq(X, vol, rcond=None)[0]
        pred = arith.mm(_features(np.asarray(contexts, dtype=dt), k1, k2,
                                  arith), coef.astype(dt))
        cols.append(pred ** 2)
    return np.stack(cols, axis=-1)
