"""The check that decides ``correct``: a sample of the window's answers,
drawn from the seed, against the plain reference in float64.

Each entry (``entries/<entry>.py``) names the numbers it compares; each
number has its limit in ``limits/<cell>.json``. The numbers:

* ``pred_rel_err``: the largest relative gap of the predicted realized
  variance, or of its standard deviation, outside the reference's tie
  interval, over the sampled contexts and maturities. The prediction is
  the softmax average over the k winners at bandwidth ``eta``: it weighs
  the nearest winners most and moves with every distance, so it judges
  the search (which windows, at which distances) through the product users
  read. The program ranks windows by float32 distances, so windows whose
  float64 distances lie within ``TIE`` of the k-th winner's may trade
  places at rank k; where the weights are near uniform (k = 10,000, or
  k = 1,024 on the MRW data) one such swap moves a prediction by up to
  ~4e-4 (``PERF.md``). The interval
  (:func:`benchmark.reference.predict.predict_interval`) holds every
  prediction those swaps can give, and nothing else.
* ``ar_rel_err`` (backtest): the same for the AR-linear benchmark.

A non-finite answer where the reference's is finite reads ``inf``.
"""
from __future__ import annotations

import math

import numpy as np

from benchmark import datagen
from benchmark.reference import predict as ref_predict

#: relative distance around the k-th winner's within which windows count
#: as tied: float32 rescoring of the winners swaps windows whose float64
#: distances differ by up to 1.6e-6 (``PERF.md``)
TIE = 1e-5
#: windows beyond the k-th that the reference returns to find the tied ones
EXTRA = 256


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float((np.abs(got - want) / np.abs(want)).max())


def sample(n_units: int, n_check: int, seed: int) -> np.ndarray:
    """Indices of the checked units, drawn from the seed."""
    rng = np.random.default_rng(datagen.sub_seed(seed, "check"))
    return np.sort(rng.choice(n_units, size=min(n_check, n_units),
                              replace=False))


def judge(values: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit. A NaN reading, or a number without a limit, never is."""
    rows = [(name, values[name], float(limits.get(name, "nan")))
            for name in values]
    return all(v <= lim for _, v, lim in rows), rows


def outside(got: np.ndarray, lo: np.ndarray, hi: np.ndarray,
            want: np.ndarray) -> np.ndarray:
    """Per row, the largest distance of ``got`` outside ``[lo, hi]``
    relative to ``want``; ``inf`` where ``got`` is not finite."""
    got = np.asarray(got, np.float64)
    gap = np.maximum(np.maximum(lo - got, got - hi), 0.0) / np.abs(want)
    gap[~np.isfinite(got)] = np.inf
    return gap.max(axis=1)


def prediction_err(config: dict, k: int, ref, contexts: np.ndarray,
                   got_avg: np.ndarray, got_std: np.ndarray) -> float:
    """``pred_rel_err`` of the program's predictions ``(B, len(Ts))`` of
    ``contexts (B, C, w)``: the largest gap outside the float64
    reference's tie interval. Prints each context's gap beside the
    interval's width and its tied windows (kept of tied)."""
    dist, fut = ref.candidates(contexts, EXTRA)
    Ts, eta = config["Ts"], config["eta"]
    avg, std = ref_predict.predict(dist[:, :k], fut[:, :k], Ts, eta, ref.arith)
    if np.shape(got_avg) != avg.shape or np.shape(got_std) != std.shape:
        return math.inf
    avg_lo, avg_hi, std_lo, std_hi, tied = ref_predict.predict_interval(
        dist, fut, k, Ts, eta, TIE)
    err = np.maximum(outside(got_avg, avg_lo, avg_hi, avg),
                     outside(got_std, std_lo, std_hi, std))
    width = np.maximum((avg_hi - avg_lo) / avg, (std_hi - std_lo) / std).max(axis=1)
    print("prediction gap outside the tie interval per checked context "
          "(interval width; tied windows kept/tied): " + ", ".join(
              f"{e:.3g} ({wd:.2g}; {m}/{n})"
              for e, wd, (m, n) in zip(err, width, tied)), flush=True)
    return float(err.max())
