"""The work of the Hedged-MC smile's kernel (``hedged_mc_smile`` in the
port's ``csrc/hedged_mc.cu``): every maturity's backward regression and the
Black-Scholes inversion of its prices, counted from shapes alone.

* Bytes: each input read once, each output written once: the price paths
  ``(B, N, H + 1)``, the weights ``(B, N)``, the strikes ``(B, nT, nK)``
  and the knots ``(B, max(Ts) - 1, m)``, all float64; the prices ``(B,
  nT, nK)`` float64 and the vols float32.
* Operations, per context and maturity ``T``, for each of its ``T - 1``
  regression steps: per path the hat basis and its row of ``[phi, phi dS]
  sqrt(w)`` (:data:`ROW_OPS`), the 16 products of the row's 4 non-zeros
  into the Gram matrix and their ``4 nK`` into the right-hand side, and
  ``C_t`` at ``nK`` strikes (2 non-zeros), two operations a product; the
  ``2m x 2m`` solve, ``2/3 (2m)^3 + 2 (2m)^2 nK``. The last step regresses
  on ``(1, dS_0)``: 4 and ``2 nK`` products a path. The payoff: 2 a path
  and strike. The inversion: :data:`BISECTIONS` + 2 Black-Scholes prices of
  :data:`BS_OPS` operations a strike.

Every operation is held to 67 TFLOP/s, an H100 SXM's float64 rate on its
tensor cores and its float32 rate outside them, and bytes to 3.35 TB/s,
so neither precision of the kernel can read over 100 %.
"""
from __future__ import annotations

from benchmark import peaks

FLOPS = 67e12
ROW_OPS = 12
BISECTIONS = 80
BS_OPS = 25
N_BASIS = 12


def smile(B: int, N: int, H: int, Ts, nK: int, m: int = N_BASIS) -> tuple:
    """``(bytes, flops)`` of one launch for ``B`` contexts of ``N`` paths
    of ``H`` steps, maturities ``Ts`` and ``nK`` strikes."""
    nT = len(Ts)
    nbytes = 8 * (B * N * (H + 1) + B * N + B * nT * nK
                  + B * max(max(Ts) - 1, 0) * m) + 12 * B * nT * nK
    step = N * (ROW_OPS + 2 * (16 + 4 * nK) + 4 * nK) \
        + 2 * (2 * m) ** 3 // 3 + 2 * (2 * m) ** 2 * nK
    last = N * 2 * (4 + 2 * nK) + 2 * N * nK
    flops = B * sum((T - 1) * step + last for T in Ts) \
        + B * nT * nK * (BISECTIONS + 2) * BS_OPS
    return nbytes, flops


def bound_seconds(nbytes: float, flops: float) -> tuple:
    """The least time the card could take, and which of the two binds."""
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = flops / FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
