"""``predict``: each query is ``PathShadowing.predict`` of one context
(closed loop, one client): the k winners' softmax-weighted realized
variance at the configuration's ``Ts``.

Traffic keys: ``k``, ``check_queries`` (queries compared with the
reference per run), ``trace_calls``.

Number compared: ``pred_rel_err``, the largest over the checked queries
of the gap of the predicted variance or its standard deviation outside the
reference's tie interval (``benchmark/check.py``).
"""
from __future__ import annotations

import numpy as np

from benchmark import check, traffic

UNIT = "query"
NUMBERS = ("pred_rel_err",)


def mix(config: dict, tr: dict, seed: int, device) -> traffic.Mix:
    ctx = traffic.contexts(config, seed, device, traffic.POOL + 1)
    return traffic.Mix(ctx[1:], ctx[0], 1)


def program(system, x) -> dict:
    avg, std = system.engine.predict(x, k=int(system.tr["k"]),
                                     to_predict=system.to_predict,
                                     eta=system.config["eta"])
    return {"avg": avg, "std": std}


def oracle(system, x) -> dict:
    _, _, avg, std = system.predictions(traffic.as_batch([x]))
    return {"avg": avg, "std": std}


def trace_units(tr: dict) -> tuple:
    return int(tr["trace_calls"]), 1


def contexts_per_search(tr: dict) -> int:
    return 1


def picked(tr: dict, inputs: list, outputs: list, seed: int):
    """The sampled queries: their contexts ``(S, C, w)`` and outputs."""
    pick = check.sample(len(outputs), int(tr["check_queries"]), seed)
    got = {key: np.concatenate([outputs[i][key] for i in pick])
           for key in outputs[0]}
    return traffic.as_batch([inputs[i] for i in pick]), got


def readings(config: dict, tr: dict, ref, inputs: list, outputs: list,
             seed: int) -> dict:
    ctx, got = picked(tr, inputs, outputs, seed)
    return {"pred_rel_err": check.prediction_err(
        config, int(tr["k"]), ref, ctx, got["avg"], got["std"])}
