"""Realized variance / volatility statistics.

Port of :mod:`shadowing_tpu.stats.realized`: mean squared log-return over the
first ``T`` steps, annualised by the trading-day count (``ANNUALIZATION``).
"""
from __future__ import annotations

from typing import Iterable

import torch

from shadowing_tpu_torch.array_types import Array, as_tensor

ANNUALIZATION = 252


def realized_variance(x: Array, Ts: Iterable[int], vol: bool = False) -> torch.Tensor:
    """Realized variance of log-returns ``x (..., T)`` at maturities ``Ts``:
    ``(..., len(Ts))``; ``vol=True`` returns its square root."""
    x2 = as_tensor(x) ** 2
    rv = torch.stack([x2[..., : int(T)].mean(dim=-1) for T in Ts], dim=-1) * ANNUALIZATION
    return torch.sqrt(rv) if vol else rv


def get_RV(x: Array, from_dln: bool = False) -> torch.Tensor:
    """Annualised realized volatility of a price (or log-return) window:
    prices annualise over ``(T-1)/252`` increments, log-returns over ``T/252``."""
    x = as_tensor(x)
    if from_dln:
        return torch.sqrt((x**2).sum(dim=-1) / (x.shape[-1] / ANNUALIZATION))
    dln = torch.diff(torch.log(x), dim=-1)
    return torch.sqrt((dln**2).sum(dim=-1) / ((x.shape[-1] - 1) / ANNUALIZATION))
