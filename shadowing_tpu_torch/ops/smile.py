"""The Hedged-MC smile's kernel (``csrc/hedged_mc.cu``): every maturity's
backward regression and the Black-Scholes inversion of its prices, one
launch for every context and maturity where there are at most 16
maturities and the strikes fit one block's shared memory.

Its plain PyTorch version is ``pricing/hedged_mc.py::_backward`` followed
by ``pricing/black_scholes.py::bs_implied_vol``, which the pricing runs on
a CPU tensor; this wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from shadowing_tpu_torch.ops._build import Kernel, ptr

SMILE = Kernel("hedged_mc_smile", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
               + [ctypes.c_double] * 2)


def hedged_mc_smile(paths: torch.Tensor, weights: torch.Tensor,
                    strikes: torch.Tensor, knots: Optional[torch.Tensor],
                    Ts: Sequence[int], discount: float, r: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call prices ``(B, nT, nK)`` float64 and their implied vols float32.

    Any number of maturities and strikes: the kernel takes up to 16
    maturities a launch and as many strikes as one block's shared memory
    holds beside the ``4 m^2 + m`` doubles of a step's normal equations
    and knots, so ``m`` is the one limit (84 on an H100, where the launch
    fails past it).

    :param paths: ``(B, N, H + 1)`` prices, ``H >= max(Ts)``
    :param weights: ``(B, N)`` path measure, rows summing to 1
    :param strikes: ``(B, nT, nK)`` strikes of each maturity
    :param knots: ``(B, max(Ts) - 1, m)`` regression knots of steps
        ``1 .. max(Ts) - 1`` (``pricing/hedged_mc.py::_regression_knots``),
        ``None`` where ``max(Ts) < 2``
    """
    dev = paths.device
    if dev.type != "cuda":
        raise ValueError(f"no hedged_mc_smile kernel for device {dev}")
    paths, weights, strikes = (a.to(torch.float64).contiguous()
                               for a in (paths, weights, strikes))
    B, N, H1 = paths.shape
    nT, nK = strikes.shape[1], strikes.shape[2]
    if knots is None:
        knots = torch.zeros((B, 0, 2), dtype=torch.float64, device=dev)
    knots = knots.to(torch.float64).contiguous()
    m = knots.shape[2]
    if (weights.shape != (B, N) or strikes.shape[0] != B or len(Ts) != nT
            or knots.shape[:2] != (B, max(max(Ts) - 1, 0))
            or max(Ts) > H1 - 1 or min(Ts) < 1 or m < 2):
        raise ValueError(f"shape mismatch: paths {tuple(paths.shape)}, "
                         f"weights {tuple(weights.shape)}, strikes "
                         f"{tuple(strikes.shape)}, knots {tuple(knots.shape)}, "
                         f"Ts {list(Ts)}")
    ts = (ctypes.c_int * nT)(*(int(T) for T in Ts))
    cbuf = torch.empty((B, nT, N, nK), dtype=torch.float64, device=dev)
    prices = torch.empty((B, nT, nK), dtype=torch.float64, device=dev)
    vols = torch.empty((B, nT, nK), dtype=torch.float32, device=dev)
    SMILE.launch(ptr(paths), ptr(weights), ptr(strikes), ptr(knots), ts,
                 ptr(cbuf), ptr(prices), ptr(vols), B, N, H1, nT, nK, m,
                 knots.shape[1], ctypes.c_double(discount), ctypes.c_double(r))
    return prices, vols
