"""Path-Dependent Volatility (PDV) models, Guyon & Lekeufack (2023).

Port of :mod:`shadowing_tpu.models.pdv`: the continuous Euler-stepped model,
the discrete daily-grid variant, the autoregressive linear volatility
benchmark, the published parameter defaults and the past-to-factors bridge
that runs PDV as a conditional generator.

* Time stepping is a plain loop over steps on ``(S, 2)`` factor tensors on
  the model's device (one path per row), in float32 as the JAX package.
* Every random draw comes from an explicit ``torch.Generator`` on the
  model's device (default: one seeded 0). Student-t innovations are
  ``Z / sqrt(V / df)`` with ``Z`` a generator-driven normal and ``V`` a
  chi-square drawn as twice a Gamma(df/2) by Marsaglia–Tsang rejection
  from generator-driven normals and uniforms, on the device.
* The Student-t calibration to a return sample is a maximum-likelihood fit
  (400 Adam steps on ``(log df, loc, log scale)``, gradients by
  ``torch.autograd``).
* The linear benchmark solves its least squares with
  ``torch.linalg.lstsq`` in float32 on the CPU, as ``jnp.linalg.lstsq``
  does in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array, as_numpy, as_tensor, resolve_device
from shadowing_tpu_torch.data.price_data import PriceData
from shadowing_tpu_torch.data.windows import windows
from shadowing_tpu_torch.stats.realized import ANNUALIZATION, get_RV

SIGMA_CLIP = (0.0, 1.5)
RETURN_FLOOR = -0.999999


def kernel_pl(taus: Array, delta: float, alpha: float) -> torch.Tensor:
    """Power-law kernel with lag offset ``delta``."""
    return (as_tensor(taus) + delta) ** (-alpha)


def kernel_exp(taus: Array, lam: float) -> torch.Tensor:
    """Exponential kernel."""
    return lam * torch.exp(-lam * as_tensor(taus))


# published Guyon-Lekeufack defaults
DEFAULT1 = {
    "power-law": {"delta": 0.044, "alpha": 2.82},
    "exp": {"lam0": 64.5, "lam1": 3.83, "theta": 0.67},
}
DEFAULT2 = {
    "power-law": {"delta": 0.025, "alpha": 1.86},
    "exp": {"lam0": 37.6, "lam1": 1.2, "theta": 0.2},
}


# --------------------------------------------------------------------------
# Student-t marginal: calibration and sampling
# --------------------------------------------------------------------------

def _t_logpdf(x, df, loc, scale):
    z = (x - loc) / scale
    return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
            - 0.5 * torch.log(df * math.pi) - torch.log(scale)
            - (df + 1) / 2 * torch.log1p(z**2 / df))


def _fit_t_mle(x: torch.Tensor, steps: int = 400
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximum-likelihood ``(df, loc, scale)`` of a Student-t via Adam on
    the unconstrained parameters ``(log(df - 0.5), loc, log scale)``."""
    x = x.detach()
    p = torch.stack([torch.log(torch.tensor(4.0, device=x.device)), x.mean(),
                     torch.log(x.std(correction=0) * 0.8)])
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    lr, b1, b2, eps = 0.05, 0.9, 0.999, 1e-8
    for i in range(steps):
        p.requires_grad_(True)
        nll = -_t_logpdf(x, torch.exp(p[0]) + 0.5, p[1], torch.exp(p[2])).mean()
        (g,) = torch.autograd.grad(nll, p)
        p = p.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g**2
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        p = p - lr * mh / (torch.sqrt(vh) + eps)
    return torch.exp(p[0]) + 0.5, p[1], torch.exp(p[2])


def _sample_gamma(a: float, n: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """``n`` Gamma(a, 1) draws by Marsaglia–Tsang rejection (acceptance
    > 95 % for a >= 1; a < 1 draws Gamma(a + 1) times ``U ** (1 / a)``)."""
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator, device=device)
        u = torch.rand(todo.numel(), generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        out = out * torch.rand(n, generator=generator, device=device) ** (1.0 / a)
    return out


def _sample_t(generator: torch.Generator, df: float, loc: float,
              scale: float, size: Tuple[int, ...],
              device: torch.device) -> torch.Tensor:
    """Student-t draws ``loc + scale * Z / sqrt(V / df)``, ``V = 2 Gamma(df/2)``."""
    n = math.prod(size)
    z = torch.randn(n, generator=generator, device=device)
    chi2 = 2.0 * _sample_gamma(df / 2.0, n, generator, device)
    return (loc + scale * z / torch.sqrt(chi2 / df)).reshape(size)


# --------------------------------------------------------------------------
# shared PDV machinery
# --------------------------------------------------------------------------

class _PDVBase:
    """Shared parameterisation: two-timescale exponential factors R1 (on
    returns) and R2 (on squared returns), convex-mixed, driving

        sigma = beta0 + beta1 * r1 + beta2 * sqrt(r2) [+ beta3 * relu(r1)^2]

    clipped to ``SIGMA_CLIP``. Paths are simulated on ``device``
    (``"cuda"``, the default, raises without a card)."""

    def __init__(
        self,
        lams1: List[float],
        lams2: List[float],
        thetas: List[float],
        betas: List[float],
        snp: Optional[PriceData] = None,
        nu: Optional[float] = None,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        self.lams1 = np.asarray(lams1, dtype=np.float64)
        self.lams2 = np.asarray(lams2, dtype=np.float64)
        self.thetas = np.asarray(thetas, dtype=np.float64)
        self.betas = np.asarray(betas, dtype=np.float64)
        self.snp = snp
        self.nu = nu
        self.device = resolve_device(device)
        self.fit_params: Optional[tuple] = None
        self._t_params: Optional[tuple] = None  # (df, loc, scale)
        if snp is not None:
            self.calibrate_log_returns(snp)
        if nu is not None:
            # an explicit nu overrides the snp-calibrated distribution
            self.define_dlnx_dist(nu)

    def define_dlnx_dist(self, nu: float) -> None:
        self._t_params = (float(nu), 0.0, 1.0)

    def calibrate_log_returns(self, snp: PriceData) -> None:
        """Fit a Student-t to the marginal of the provided log-returns."""
        data = torch.as_tensor(np.ravel(snp.dlnx), dtype=torch.float32,
                               device=self.device)
        self.fit_params = tuple(float(p) for p in _fit_t_mle(data))
        self._t_params = self.fit_params

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            return torch.Generator(device=self.device).manual_seed(0)
        return generator

    def _lams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.lams1, dtype=torch.float32, device=self.device),
                torch.tensor(self.lams2, dtype=torch.float32, device=self.device))

    def _factors(self, R0: Array, S: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(R0, np.float32),
                               device=self.device).expand(S, 2)

    def gen_dw(self, s: float, size: Tuple[int, ...],
               generator: torch.Generator) -> torch.Tensor:
        """Standardised innovations scaled by ``s``: per path (last axis)
        mean zero and unit standard deviation."""
        if self._t_params is not None:
            df, loc, scale = self._t_params
            dw = _sample_t(generator, df, loc, scale, size, self.device)
        else:
            dw = torch.randn(size, generator=generator, device=self.device)
        dw = dw - dw.mean(-1, keepdim=True)
        dw = dw / dw.std(-1, keepdim=True, correction=0)
        return dw * s

    @staticmethod
    def mixing(theta: float, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        return (1 - theta) * x0 + theta * x1

    def sigma_of(self, R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
        """Volatility from factor pairs; R1, R2 have trailing dim 2."""
        b = [float(x) for x in self.betas]
        r1 = self.mixing(float(self.thetas[0]), R1[..., 0], R1[..., 1])
        r2 = self.mixing(float(self.thetas[1]), R2[..., 0], R2[..., 1])
        sig = b[0] + b[1] * r1 + b[2] * torch.sqrt(torch.clamp(r2, min=0.0))
        if len(b) > 3:
            sig = sig + b[3] * (0.5 * torch.abs(r1) + 0.5 * r1) ** 2
        return torch.clamp(sig, *SIGMA_CLIP)

    def sigma(self, R1: Array, R2: Array) -> np.ndarray:
        """Numpy-friendly alias: float32 factors with trailing dim 2 —
        ``(2,)`` for a single state, ``(S, 2)`` for a batch."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        return as_numpy(self.sigma_of(f32(R1), f32(R2)))


class PDVModel(_PDVBase):
    """Continuous-time PDV model, Euler stepping.

    Factor dynamics: ``dR1 = (sigma dW - R1 dt) lam1``,
    ``dR2 = (sigma^2 - R2) dt lam2``.
    """

    def gen(
        self,
        T: float,
        dt: float,
        S0: float,
        R10: Array,
        R20: Array,
        S: int = 1,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Simulate ``S`` paths of (sigma_t, S_t) over ``int(T/dt)`` steps.

        Returns arrays of shape ``(n_steps,)`` when ``S == 1`` else
        ``(S, n_steps)``.
        """
        n_steps = int(T / dt)
        dW = self.gen_dw(float(np.sqrt(dt)), (S, n_steps - 1),
                         self._generator(generator))
        lams1, lams2 = self._lams()
        R1, R2 = self._factors(R10, S), self._factors(R20, S)
        price = torch.full((S,), float(S0), device=self.device)
        sigs, prices = [self.sigma_of(R1, R2)], [price]
        for t in range(n_steps - 1):
            sig = self.sigma_of(R1, R2)
            dwt = dW[:, t]
            price = price * (1 + sig * dwt)
            R1 = R1 + (sig[:, None] * dwt[:, None] - R1 * dt) * lams1
            R2 = R2 + (sig[:, None] ** 2 - R2) * dt * lams2
            sigs.append(sig)
            prices.append(price)
        sigma = as_numpy(torch.stack(sigs, dim=1))
        path = as_numpy(torch.stack(prices, dim=1))
        if S == 1:
            return sigma[0], path[0]
        return sigma, path


class PDVModelDiscrete(_PDVBase):
    """Daily-grid PDV variant.

    Exponential-decay factor updates driven by the *realized* return
    ``r_t = max(sigma_t dW_t, RETURN_FLOOR)``:
    ``R1' = exp(-lam/252) R1 + lam r_t``,
    ``R2' = exp(-lam/252) R2 + lam r_t^2``.
    """

    def gen(
        self,
        T: float,
        dt: float,
        S0: float,
        S: int,
        R10: Array,
        R20: Array,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(sigma, S)`` paths, each ``(S, int(T/dt))``."""
        if abs(dt - 1 / ANNUALIZATION) > 1e-6:
            raise ValueError("dt must be one trading day (1/252) in the "
                             "discrete model")
        n_steps = int(T / dt)
        dW = self.gen_dw(float(np.sqrt(dt)), (S, n_steps),
                         self._generator(generator))
        lams1, lams2 = self._lams()
        decay1 = torch.exp(-lams1 / ANNUALIZATION)
        decay2 = torch.exp(-lams2 / ANNUALIZATION)
        R1, R2 = self._factors(R10, S), self._factors(R20, S)
        price = torch.full((S,), float(S0), device=self.device)
        sigs, prices = [self.sigma_of(R1, R2)], [price]
        # the first column keeps S0 and sigma(R10, R20); the shocks
        # dW[:, 0] are drawn but never applied
        for t in range(1, n_steps):
            sig = self.sigma_of(R1, R2)
            rt = torch.clamp(sig * dW[:, t], min=RETURN_FLOOR)
            price = price * (1 + rt)
            R1 = decay1 * R1 + lams1 * rt[:, None]
            R2 = decay2 * R2 + lams2 * rt[:, None] ** 2
            sigs.append(sig)
            prices.append(price)
        return (as_numpy(torch.stack(sigs, dim=1)),
                as_numpy(torch.stack(prices, dim=1)))


# --------------------------------------------------------------------------
# autoregressive linear volatility benchmark
# --------------------------------------------------------------------------

class AutoregressiveLinearPredictor:
    """Linear regression of future realized vol on kernel-weighted past
    returns and squared returns (host numpy, least squares in torch)."""

    def __init__(
        self,
        T: int,
        w: int,
        s: int,
        dt: float,
        ktype: Literal["exp", "power-law"],
        k1_dict: Optional[Dict] = None,
        k2_dict: Optional[Dict] = None,
        extra_term: bool = False,
    ):
        self.T = T
        self.w = w
        self.s = s
        self.dt = dt
        k1_dict = k1_dict if k1_dict is not None else DEFAULT1[ktype]
        k2_dict = k2_dict if k2_dict is not None else DEFAULT2[ktype]
        if ktype == "power-law":
            self.k1 = self.init_pl_kernel(w=w, dt=dt, **k1_dict)
            self.k2 = self.init_pl_kernel(w=w, dt=dt, **k2_dict)
        else:
            self.k1 = self.init_exp_kernel_2_factors(w=w, dt=dt, **k1_dict)
            self.k2 = self.init_exp_kernel_2_factors(w=w, dt=dt, **k2_dict)
        self.extra_term = extra_term
        self.coef_: Optional[np.ndarray] = None

    @staticmethod
    def init_exp_kernel_2_factors(w, dt, lam0, lam1, theta) -> np.ndarray:
        """Convex mix of two exponential kernels, each normalised to unit
        mass per unit time."""
        taus = np.arange(w)[::-1] * dt
        k0 = as_numpy(kernel_exp(taus, lam=lam0))
        k1 = as_numpy(kernel_exp(taus, lam=lam1))
        k0 = k0 / k0.sum() / dt
        k1 = k1 / k1.sum() / dt
        return (1 - theta) * k0 + theta * k1

    @staticmethod
    def init_pl_kernel(w, dt, delta, alpha) -> np.ndarray:
        taus = np.arange(w)[::-1] * dt
        kern = as_numpy(kernel_pl(taus, delta=delta, alpha=alpha))
        return kern * ANNUALIZATION / kern.sum()

    def separate(self, x: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Training pairs from one price series: every stride-``s`` span of
        ``w + 1 + T`` prices yields a (past, future) pair sharing exactly one
        price sample, so the past log-returns and the future realized vol
        are built from disjoint increments.

        :return: (past sample indices, future sample indices,
            past log-returns ``(n, w)``, future realized vols ``(n,)``)
        """
        if x.ndim != 1:
            raise ValueError(f"separate takes one 1-d price series, got {x.shape}")
        span = self.w + 1 + self.T
        prices = windows(x, w=span, s=self.s)            # (n, span)
        sample_idx = windows(np.arange(x.size), w=span, s=self.s)
        past = prices[:, : self.w + 1]                   # shares prices[w]
        future = prices[:, self.w :]
        return (
            sample_idx[:, : self.w],
            sample_idx[:, self.w :],
            np.diff(np.log(past)),
            as_numpy(get_RV(future)),
        )

    @staticmethod
    def embedding(dlnx, k1, k2, extra_term: bool = False) -> np.ndarray:
        """Guyon–Lekeufack feature map of a window of log-returns: constant,
        trend factor ``R1 = <k1, r>``, volatility factor
        ``R2 = sqrt(<k2, r^2>)`` — plus ``relu(R1)^2`` when ``extra_term``."""
        r = np.atleast_2d(np.asarray(dlnx))
        k1 = np.asarray(k1)
        k2 = np.asarray(k2)
        if not r.shape[-1] == k1.size == k2.size:
            raise ValueError(f"windows of {r.shape[-1]} returns, kernels of "
                             f"{k1.size} and {k2.size} taps")
        R1 = r @ k1
        R2 = np.sqrt((r * r) @ k2)
        cols = [np.ones_like(R1), R1, R2]
        if extra_term:
            cols.append(np.square(np.maximum(R1, 0.0)))
        return np.stack(cols, axis=-1)

    def train(self, x: np.ndarray) -> None:
        """Least-squares fit (no intercept — the feature map carries the
        constant column)."""
        _, _, dlnx, y = self.separate(x)
        X = self.embedding(dlnx, self.k1, self.k2, self.extra_term)
        sol = torch.linalg.lstsq(
            torch.as_tensor(X, dtype=torch.float32),
            torch.as_tensor(y, dtype=torch.float32)[:, None]).solution[:, 0]
        self.coef_ = as_numpy(sol)

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self.coef_ is None:
            raise RuntimeError("call train() first")
        X = self.embedding(x, self.k1, self.k2, self.extra_term)
        return X @ self.coef_


# --------------------------------------------------------------------------
# PDV as a conditional generator
# --------------------------------------------------------------------------

def compute_factor(
    x_past: np.ndarray,
    pdv_model: _PDVBase,
    w: int,
    dt: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Initial factors (R10, R20) implied by an observed past price path."""
    dlnx = np.diff(np.log(np.asarray(x_past)), axis=-1)

    taus = np.arange(w)[::-1][1:] * dt
    kerns = []
    for lam in (*pdv_model.lams1, *pdv_model.lams2):
        k = as_numpy(kernel_exp(taus, lam=lam))
        kerns.append(k / k.sum() / dt)
    k10, k11, k20, k21 = kerns

    if dlnx.shape[-1] != taus.size:
        dlnx = dlnx[..., -taus.size :]

    e0 = AutoregressiveLinearPredictor.embedding(dlnx, k10, k20)
    e1 = AutoregressiveLinearPredictor.embedding(dlnx, k11, k21)
    R10 = np.array([e0[0, 1], e1[0, 1]])
    R20 = np.array([e0[0, 2], e1[0, 2]]) ** 2.0
    return R10, R20


def future_pdv_model(
    x_past: np.ndarray,
    pdv_model: _PDVBase,
    w: int,
    S0: float,
    S: int,
    T: float,
    dt: float,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Conditional PDV futures ``(S, int(T/dt))`` given an observed past."""
    R10, R20 = compute_factor(x_past, pdv_model, w, dt)
    _, x_gen = pdv_model.gen(T=T, dt=dt, S0=S0, S=S, R10=R10, R20=R20,
                             generator=generator)
    return x_gen
