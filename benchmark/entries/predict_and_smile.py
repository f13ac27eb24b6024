"""``predict_and_smile``: each query is ``PathShadowing.predict_and_smile``
of one context (closed loop, one client): one search of the k winners,
then both products, the softmax-weighted realized variance at the
configuration's ``Ts`` and ``eta``, and the Hedged-MC call prices and
implied vols at every maturity ``Ts`` and moneyness ``Ms`` under the
Softmax measure at ``eta_smile``.

Traffic keys: ``k``, ``Ms``, ``eta_smile``, ``x_init`` (the paths' first
price), ``r``, ``check_queries`` (queries compared with the reference per
run), ``trace_calls``.

Numbers compared, over the checked queries, every maturity and moneyness:

* ``pred_rel_err``: as ``predict`` (``benchmark/check.py``).
* ``smile_price_err``: the largest gap of a price, as a share of the spot,
  outside the reference's prices over every choice of the tied windows at
  rank k (those :func:`benchmark.check.prediction_err` counts; at most
  :data:`CHOICES` choices a query). Every price counts, however few paths
  carry the weight.
* ``smile_vol_err``: the largest gap of an implied vol outside the
  reference's over those choices, where every choice has a vol and its
  price lies at least :data:`VOL_FLOOR` of the spot inside the prices that
  have one.

A non-finite answer where the reference's is finite reads ``inf``.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from benchmark import check, traffic
from benchmark.entries import predict
from benchmark.reference import hedged_mc

UNIT = "query"
NUMBERS = ("pred_rel_err", "smile_price_err", "smile_vol_err")
#: share of the spot by which a price has to lie inside the prices that
#: have a vol (``hedged_mc.room``) for its vol to be compared. Nearer the
#: edge a vol is the price's error over a vega that goes to 0 with the
#: room: the port inverts Black-Scholes in float32 (its prices rounded by
#: ~1e-6 of the spot) and has no vol just outside the edge. With 1e-4 of
#: room its vols stay within 2.1e-5 of the reference's (``PERF.md``)
VOL_FLOOR = 1e-4
#: choices of the windows tied at rank k priced per query, at most; fewer
#: choices give a narrower interval, so a stricter check
CHOICES = 32

mix = predict.mix
trace_units = predict.trace_units
contexts_per_search = predict.contexts_per_search


def _smile_arrays(smiles) -> dict:
    return {key: np.stack([getattr(s, key) for s in smiles])
            for key in ("prices", "vols", "strikes")}


def program(system, x) -> dict:
    cfg, tr = system.config, system.tr
    avg, std, smiles = system.engine.predict_and_smile(
        x, k=int(tr["k"]), to_predict=system.to_predict, Ts=cfg["Ts"],
        Ms=tr["Ms"], eta=cfg["eta"], eta_smile=tr["eta_smile"], r=tr["r"],
        x_init=tr["x_init"])
    return {"avg": avg, "std": std, **_smile_arrays(smiles)}


def _reference(dist, fut, tr: dict, Ts, arith) -> dict:
    return hedged_mc.smile(dist, fut, Ts, tr["Ms"], tr["eta_smile"],
                           tr["x_init"], tr["r"], arith)


def oracle(system, x) -> dict:
    dist, fut, avg, std = system.predictions(traffic.as_batch([x]))
    sm = _reference(dist[0], fut[0], system.tr, system.config["Ts"],
                    system.arith)
    return {"avg": avg, "std": std,
            **{key: sm[key][None] for key in ("prices", "vols", "strikes")}}


def tie_choices(dist: np.ndarray, k: int) -> list:
    """Index sets of the k winners over every choice of the windows tied
    at rank k among the candidates ``dist (K,)`` ascending (as
    ``reference.predict.predict_interval`` counts them), at most
    :data:`CHOICES` of them."""
    dk = dist[k - 1]
    tied = np.flatnonzero((dist >= dk * (1.0 - check.TIE))
                          & (dist <= dk * (1.0 + check.TIE)))
    sure = np.flatnonzero(dist < dk * (1.0 - check.TIE))
    kept = int((tied < k).sum())
    return [np.concatenate([sure, c]) for c in
            itertools.islice(itertools.combinations(tied, kept), CHOICES)]


def _outside(got, lo, hi) -> np.ndarray:
    gap = np.maximum(np.maximum(lo - got, got - hi), 0.0)
    return np.where(np.isfinite(got), gap, np.inf)


def smile_gaps(tr: dict, Ts, dist: np.ndarray, fut: np.ndarray, got: dict,
               arith) -> tuple:
    """``(price gaps, vol gaps, effective paths, choices)`` per query of
    the program's answers ``got`` (each ``(B, nT, nM)``) against the
    reference's over the tie choices of the candidates ``dist (B, K)`` and
    ``fut (B, K, h)``."""
    k, spot = int(tr["k"]), float(tr["x_init"])
    price_gap, vol_gap, n_eff, n_choices = [], [], [], []
    for b in range(dist.shape[0]):
        refs = [_reference(dist[b, idx], fut[b, idx], tr, Ts, arith)
                for idx in tie_choices(dist[b], k)]
        prices = np.stack([r["prices"] for r in refs])
        vols = np.stack([r["vols"] for r in refs])
        room = np.stack([r["room"] for r in refs])
        p, v = np.asarray(got["prices"][b], np.float64), np.asarray(
            got["vols"][b], np.float64)
        if p.shape != prices.shape[1:] or v.shape != vols.shape[1:]:
            price_gap.append(math.inf)
            vol_gap.append(math.inf)
        else:
            price_gap.append(float(_outside(p, prices.min(0),
                                            prices.max(0)).max()) / spot)
            compared = (np.isfinite(vols) & (room >= VOL_FLOOR * spot)).all(0)
            gaps = _outside(v, vols.min(0), vols.max(0))[compared]
            vol_gap.append(float(gaps.max()) if gaps.size else 0.0)
        n_eff.append(hedged_mc.effective_paths(dist[b, :k], tr["eta_smile"]))
        n_choices.append(len(refs))
    return price_gap, vol_gap, n_eff, n_choices


class _Found:
    """The reference's candidates of the checked queries, searched once
    for both checks."""

    def __init__(self, ref, contexts: np.ndarray):
        self.arith = ref.arith
        self.found = ref.candidates(contexts, check.EXTRA)

    def candidates(self, contexts: np.ndarray, extra: int):
        return self.found


def readings(config: dict, tr: dict, ref, inputs: list, outputs: list,
             seed: int) -> dict:
    ctx, got = predict.picked(tr, inputs, outputs, seed)
    found = _Found(ref, ctx)
    pred = check.prediction_err(config, int(tr["k"]), found, ctx, got["avg"],
                                got["std"])
    price_gap, vol_gap, n_eff, n_choices = smile_gaps(
        tr, config["Ts"], *found.found, got, ref.arith)
    print("smile per checked query, effective paths 1/sum(w^2): price gap "
          "/ spot, vol gap (tie choices): " + ", ".join(
              f"{n:.3g}: {p:.3g}, {v:.3g} ({c})"
              for n, p, v, c in zip(n_eff, price_gap, vol_gap, n_choices)),
          flush=True)
    return {"pred_rel_err": pred, "smile_price_err": max(price_gap),
            "smile_vol_err": max(vol_gap)}
