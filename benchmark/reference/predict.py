"""Prediction from the k winners: the Gaussian-kernel (softmax) average of
each winner's realized variance, and its weighted standard deviation.

Realized variance over the first ``T`` future returns is ``252 *
mean(r^2)``; a winner at distance ``d`` weighs ``exp(-d^2 / (2 eta^2))``,
normalised over the k winners.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.precision import FLOAT64, Arith

ANNUALIZATION = 252


def softmax_weights(dist: np.ndarray, eta: float) -> np.ndarray:
    """``(B, k)`` weights of the winners, rows summing to 1."""
    z = -0.5 * (np.asarray(dist, dtype=np.float64) / eta) ** 2
    w = np.exp(z - z.max(axis=1, keepdims=True))
    return w / w.sum(axis=1, keepdims=True)


def realized_variance(returns: np.ndarray, Ts, arith: Arith) -> np.ndarray:
    """``(..., len(Ts))`` annualised realized variance of ``(..., h)``
    returns over their first ``T`` samples."""
    return np.stack([arith.sumsq(returns[..., : int(T)]) / int(T)
                     for T in Ts], axis=-1) * ANNUALIZATION


def predict(dist: np.ndarray, future: np.ndarray, Ts, eta: float,
            arith: Arith):
    """Weighted mean and standard deviation ``(B, len(Ts))`` of the
    winners' realized variance; ``future (B, k, h)`` are their returns."""
    w = arith.q(softmax_weights(dist, eta))[..., None]         # (B, k, 1)
    rv = realized_variance(arith.q(future), Ts, arith)          # (B, k, nT)
    avg = arith.wsum(w, rv, axis=1)
    var = arith.wsum(w, (rv - avg[:, None, :]) ** 2, axis=1)
    return avg, np.sqrt(np.maximum(var, 0.0))


def _extreme_sums(v: np.ndarray, m: int) -> tuple:
    """Sums of the ``m`` smallest and of the ``m`` largest of ``v (n,
    ...)`` along the first axis."""
    s = np.sort(v, axis=0)
    return s[:m].sum(axis=0), s[len(s) - m :].sum(axis=0)


def predict_interval(dist: np.ndarray, future: np.ndarray, k: int, Ts,
                     eta: float, tie: float) -> tuple:
    """Bounds on the prediction of :func:`predict` over every set of k
    winners that a search whose distances err by up to ``tie / 2``
    (relative) could return.

    ``dist (B, K)`` ascending float64 and ``future (B, K, h)`` are the
    ``K > k`` nearest windows of each context. Windows within a factor
    ``1 +- tie`` of the k-th distance may trade places: any ``m`` of those
    ``n`` tied windows complete the ``k - m`` sure ones, where ``m`` is
    how many of them the float64 order keeps. Returns ``(avg_lo, avg_hi,
    std_lo, std_hi)``, each ``(B, len(Ts))``, and the tied counts ``(B,
    2)`` as ``(m, n)``. The mean's bounds take the sums of the weighted
    variances and of the weights to their extremes apart; the variance's
    take the weighted squared deviations from the float64 mean apart, less
    the largest square shift of the mean.
    """
    dist = np.asarray(dist, dtype=np.float64)
    out = np.empty((4, dist.shape[0], len(Ts)))
    counts = np.empty((dist.shape[0], 2), dtype=np.int64)
    rv_all = realized_variance(np.asarray(future, np.float64), Ts, FLOAT64)
    for b, d in enumerate(dist):
        dk = d[k - 1]
        tied = (d >= dk * (1.0 - tie)) & (d <= dk * (1.0 + tie))
        if tied[-1]:
            raise ValueError("the tie window reaches past the candidates")
        sure = d < dk * (1.0 - tie)
        m, n = int(tied[:k].sum()), int(tied.sum())
        z = -0.5 * (d / eta) ** 2
        w = np.exp(z - z[0])[:, None]                    # (K, 1)
        rv = rv_all[b]                                    # (K, nT)
        c = (w[:k] * rv[:k]).sum(0) / w[:k].sum()         # the float64 mean
        w_s, w_t = w[sure], w[tied]
        w_lo, w_hi = _extreme_sums(w_t, m)
        num_lo, num_hi = _extreme_sums(w_t * rv[tied], m)
        den_lo = w_s.sum() + w_lo
        den_hi = w_s.sum() + w_hi
        avg_lo = ((w_s * rv[sure]).sum(0) + num_lo) / den_hi
        avg_hi = ((w_s * rv[sure]).sum(0) + num_hi) / den_lo
        q_s = (w_s * (rv[sure] - c) ** 2).sum(0)
        q_lo, q_hi = _extreme_sums(w_t * (rv[tied] - c) ** 2, m)
        shift = np.maximum((avg_lo - c) ** 2, (avg_hi - c) ** 2)
        var_lo = (q_s + q_lo) / den_hi - shift
        var_hi = (q_s + q_hi) / den_lo
        out[:, b] = (avg_lo, avg_hi, np.sqrt(np.maximum(var_lo, 0.0)),
                     np.sqrt(var_hi))
        counts[b] = (m, n)
    return (*out, counts)
