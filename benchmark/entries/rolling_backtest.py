"""``rolling_backtest``: each call backtests ``dates_per_call`` dates of the
bundled S&P-like series, from an offset drawn from the seed, in the port's
default chunks of 64 contexts, beside the ``benchmark`` (AR-linear)
predictor fitted on the same span.

Traffic keys: ``k``, ``dates_per_call``, ``chunk_dates`` (the port's
chunk, for the per-layer unit), ``benchmark``, ``check_dates`` (dates
compared with the reference per run), ``trace_calls``.
"""
from __future__ import annotations

import numpy as np

from benchmark import check, datagen, traffic
from benchmark.reference import ar_linear

UNIT = "chunk"
NUMBERS = ("pred_rel_err", "ar_rel_err")


def span_length(config: dict, tr: dict) -> int:
    """Returns a call reads: its dates, the context before the first and
    the longest maturity after the last."""
    return (int(tr["dates_per_call"]) + traffic.context_width(config)
            + max(config["Ts"]) - 1)


def contexts(span: np.ndarray, config: dict) -> np.ndarray:
    """``(dates, w)`` contexts of a span: date ``i`` sees ``span[i : i + w]``
    and is scored on the ``max(Ts)`` returns after it."""
    w = traffic.context_width(config)
    n = span.size - w - max(config["Ts"]) + 1
    return span[np.arange(n)[:, None] + np.arange(w)]


def mix(config: dict, tr: dict, seed: int, device) -> traffic.Mix:
    series = datagen.snp_returns()
    n = span_length(config, tr)
    offsets = traffic.rng(seed).integers(0, series.size - n + 1,
                                         size=traffic.POOL + 1)
    spans = [series[o : o + n] for o in offsets]
    return traffic.Mix(spans[1:], spans[0], int(tr["dates_per_call"]))


def program(system, span) -> dict:
    cfg, tr = system.config, system.tr
    res = system.st.rolling_backtest(
        system.engine, span, w=traffic.context_width(cfg), Ts=cfg["Ts"],
        k=int(tr["k"]), eta=cfg["eta"], benchmark=tr["benchmark"])
    return {"predicted": res.predicted, "std": res.predicted_std,
            "benchmark": res.benchmark_predicted}


def oracle(system, span) -> dict:
    ctx = contexts(np.asarray(span), system.config)
    B = int(system.tr["chunk_dates"])
    parts = [system.predictions(ctx[i : i + B, None, :])[2:]
             for i in range(0, len(ctx), B)]
    return {"predicted": np.concatenate([p[0] for p in parts]),
            "std": np.concatenate([p[1] for p in parts]),
            "benchmark": ar_linear.ar_linear(span, ctx, system.config["Ts"],
                                             ctx.shape[1], system.arith)}


def trace_units(tr: dict) -> tuple:
    return int(tr["trace_calls"]), int(tr["dates_per_call"]) // int(tr["chunk_dates"])


def contexts_per_search(tr: dict) -> int:
    return int(tr["chunk_dates"])


def readings(config: dict, tr: dict, ref, inputs: list, outputs: list,
             seed: int) -> dict:
    per_call = outputs[0]["predicted"].shape[0]
    pick = check.sample(len(outputs) * per_call, int(tr["check_dates"]), seed)
    calls, dates = pick // per_call, pick % per_call
    ctx = np.stack([contexts(inputs[c], config)[d] for c, d in zip(calls, dates)])
    got = {key: np.stack([outputs[c][key][d] for c, d in zip(calls, dates)])
           for key in ("predicted", "std", "benchmark")}
    bench = np.empty(got["benchmark"].shape)
    for c in np.unique(calls):
        rows = calls == c
        bench[rows] = ar_linear.ar_linear(inputs[c], ctx[rows], config["Ts"],
                                          ctx.shape[1], ref.arith)
    return {"pred_rel_err": check.prediction_err(
                config, int(tr["k"]), ref, ctx[:, None, :], got["predicted"],
                got["std"]),
            "ar_rel_err": check.rel_err(got["benchmark"], bench)}
