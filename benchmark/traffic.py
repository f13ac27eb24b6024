"""The traffic generator's shared parts: a mix file (``traffic/<mix>.json``)
names its ``entry`` (``entries/<entry>.py``) and its sizes, and the entry
draws the inputs of a closed loop from ``--seed`` with these helpers.

Contexts come from the configuration's ``contexts``: ``snp_daily`` takes
the ``w`` returns ending at a date drawn from the seed in the bundled
S&P-like series; ``normal`` draws a fresh standard normal window on the
device. Every seed gets the same sizes; only the order and the data change.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from benchmark import datagen

#: distinct inputs drawn per run; the loop cycles through them
POOL = 8192


@dataclass
class Mix:
    """The inputs of one run: ``inputs(i)`` is the i-th call's input,
    ``warm`` the set-up's, drawn apart; each call completes
    ``units_per_call`` units of the cell's rate (dates or queries)."""

    pool: Any
    warm: Any
    units_per_call: int

    def inputs(self, i: int):
        return self.pool[i % len(self.pool)]


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(datagen.sub_seed(seed, "traffic"))


def context_width(config: dict) -> int:
    emb = config["embedding"]
    return int(emb["dim"] if emb["kind"] == "identity" else emb["width"])


def contexts(config: dict, seed: int, device, n: int) -> list:
    """``n`` contexts ``(1, C, w)``, one per query."""
    w = context_width(config)
    src = config["contexts"]
    if src["kind"] == "snp_daily":
        series = datagen.snp_returns().astype(np.float32)
        ends = rng(seed).integers(w, series.size + 1, size=n)
        return [series[e - w : e].reshape(1, 1, w) for e in ends]
    if src["kind"] == "normal":
        gen = datagen.generator(seed, "contexts", device)
        C = int(config["dataset"].get("C", 1))
        data = torch.randn((n, 1, C, w), generator=gen, device=device)
        return list(data * float(src.get("std", 1.0)))
    raise ValueError(f"unknown context source {src['kind']!r}")


def as_batch(inputs: list) -> np.ndarray:
    """Host float64 ``(B, C, w)`` of ``(1, C, w)`` contexts."""
    return np.concatenate([torch.as_tensor(x).cpu().double().numpy()
                           for x in inputs])
