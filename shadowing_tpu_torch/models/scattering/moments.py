"""Wavelet scattering-spectra statistics (arXiv:2204.10177).

Port of :mod:`shadowing_tpu.models.scattering.moments` on ``torch.fft``. The
statistic vector Phi(x) summarises a time series x through its wavelet
transform W_j x and second-level transforms of the envelopes |W_j x|:

* ``mean``                 <x>
* ``variance``             Var(x)
* ``power``     Phi_2(j) = <|W_j x|^2> / Var(x)                     (J real)
* ``sparsity``  s(j)     = <|W_j x|>^2 / <|W_j x|^2>                (J real)
* ``flatness``  f(j)     = log <|W_j x|^4> / <|W_j x|^2>^2          (J real)
* ``phase-env`` Phi_3(a,b) = <W_b(|W_a x|) conj(W_b x)> / (sig_a sig_b)
                for a < b                              (J(J-1)/2 complex)
* ``env-corr``  Phi_4(a,b,c) = <W_c(|W_a x|) conj(W_c(|W_b x|))>
                / (sig_a sig_b), for a <= b < c        (~J^3/6 complex)

with ``sig_j = sqrt(<|W_j x|^2>)``. Gaussian white noise has Phi_3 = Phi_4 =
0, sparsity pi/4 and flatness log 2. Everything is float32 and
differentiable: the synthesis optimiser takes ``torch.autograd.grad`` of a
loss on the flattened vector.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from shadowing_tpu_torch.array_types import Array, as_tensor, fp32_exact
from shadowing_tpu_torch.models.scattering.wavelets import FilterBank


def _index_pairs(J: int) -> Tuple[np.ndarray, np.ndarray]:
    a, b = np.triu_indices(J, k=1)
    return a.astype(np.int32), b.astype(np.int32)


def _index_triples(J: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    trip = [
        (a, b, c)
        for c in range(J)
        for a in range(c)
        for b in range(a, c)
    ]
    arr = np.asarray(trip, dtype=np.int32).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def n_stats(J: int) -> int:
    n_pairs = J * (J - 1) // 2
    n_trip = len(_index_triples(J)[0])
    return 2 + 3 * J + 2 * n_pairs + 2 * n_trip


@lru_cache(maxsize=None)
def _pair_perm(J: int) -> np.ndarray:
    """Permutation from b-grouped phi3 blocks to canonical triu order."""
    mine = [(a, b) for b in range(1, J) for a in range(b)]
    canon = list(zip(*_index_pairs(J)))
    return np.asarray([mine.index(p) for p in canon], np.int32)


@lru_cache(maxsize=None)
def _trip_perm(J: int) -> np.ndarray:
    """Permutation from b-grouped phi4 blocks to canonical triple order."""
    mine = [
        (a, b, c)
        for b in range(J - 1)
        for a in range(b + 1)
        for c in range(b + 1, J)
    ]
    canon = list(zip(*_index_triples(J)))
    return np.asarray([mine.index(t) for t in canon], np.int32)


@lru_cache(maxsize=None)
def _device_indices(J: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``(perm3, ia, ib, perm4, ta, tb)`` as int64 tensors on ``device``.

    Made once per (J, device): indexing a CUDA tensor with a host array
    copies the array from pageable memory, which waits for the stream —
    once per call of the statistics, i.e. per Adam step."""
    ia, ib = _index_pairs(J)
    ta, tb, _ = _index_triples(J)
    return tuple(torch.as_tensor(a.astype(np.int64), device=device)
                 for a in (_pair_perm(J), ia, ib, _trip_perm(J), ta, tb))


def _scattering_stats_flat(
    x: torch.Tensor,         # (B, T) real series (log-returns), float32
    psi_hat: torch.Tensor,   # (J, T) float32, on x's device
    J: int,
    bands: tuple | None = None,  # per-scale support bins (FilterBank.band_hi)
) -> torch.Tensor:           # (B, n_stats) float32
    """The flat statistic vector of every row of ``x``.

    On a CUDA device, call it under :func:`array_types.fp32_exact` (forward
    and backward): the Phi_3/Phi_4 contractions are matmuls, and TF32's
    ~1e-3 error is as large as the synthesis tolerance's margin (the JAX
    package pins ``Precision.HIGH`` on them)."""
    B, T = x.shape
    half = T // 2 + 1
    perm3, ia, ib, perm4, ta, tb = _device_indices(J, x.device)
    mean = x.mean(dim=-1)
    xc = x - mean[:, None]
    var = (xc**2).mean(dim=-1)

    # wavelet transforms; the filters are strictly analytic (zero at all
    # negative bins and at Nyquist), so only the non-negative half spectrum
    # carries signal
    xf = torch.fft.fft(xc, dim=-1)                      # (B, T) complex
    xf_h = xf[..., :half]
    xr, xi = xf_h.real, xf_h.imag
    w = torch.fft.ifft(xf[:, None, :] * psi_hat[None], dim=-1)
    # the gradient of |w| at an exactly zero coefficient is 0 here (torch's
    # sgn(0) = 0) and in JAX (its abs JVP divides by |w| with 0 replaced by
    # 1), so both packages step such a coordinate alike
    env = w.abs()                                       # (B, J, T)

    p2 = (env**2).mean(dim=-1)                          # (B, J)
    sig = torch.sqrt(torch.clamp(p2, min=1e-30))
    power = p2 / torch.clamp(var[:, None], min=1e-30)
    sparsity = env.mean(dim=-1) ** 2 / torch.clamp(p2, min=1e-30)
    p4 = (env**4).mean(dim=-1)
    flatness = torch.log(torch.clamp(p4, min=1e-60)) - 2.0 * torch.log(
        torch.clamp(p2, min=1e-30))

    # Phi_3 / Phi_4 by Parseval: for spectra F, G,
    #   mean_t( ifft(F) conj(ifft(G)) ) = (1/T^2) sum_w F(w) conj(G(w)),
    # and both statistics pair spectra that share the SAME outer wavelet:
    #   Phi_3(a,b)   -> sum_w ef_a conj(xf) |psi_b|^2
    #   Phi_4(a,b,c) -> sum_w ef_a conj(ef_b) |psi_c|^2
    # with e_j the centred envelopes, summed over the non-negative half
    # spectrum, in real/imag planes, and truncated where |psi|^2 is below
    # 1e-12 of its peak (``bands``; exact to ~1e-12 relative).
    envc = env - env.mean(dim=-1, keepdim=True)
    S = (psi_hat.abs() ** 2)[:, :half]                  # (J, half) real
    ef_h = torch.fft.fft(envc, dim=-1)[..., :half]
    er, ei = ef_h.real, ef_h.imag
    inv_T2 = 1.0 / (float(T) * T)
    if bands is None:
        bands = (half,) * J

    p3r, p3i = [], []
    for b in range(1, J):
        hi = bands[b]
        era, eia = er[:, :b, :hi], ei[:, :b, :hi]
        xrh, xih = xr[:, None, :hi], xi[:, None, :hi]
        Sb = S[b, :hi]
        # z = ef_a * conj(xf)
        p3r.append(torch.einsum("bat,t->ba", era * xrh + eia * xih, Sb))
        p3i.append(torch.einsum("bat,t->ba", eia * xrh - era * xih, Sb))
    if p3r:
        p3r = torch.cat(p3r, dim=1)[:, perm3] * inv_T2
        p3i = torch.cat(p3i, dim=1)[:, perm3] * inv_T2
    else:
        p3r = p3i = x.new_zeros((B, 0))
    norm3 = sig[:, ia] * sig[:, ib]
    phi3_r, phi3_i = p3r / norm3, p3i / norm3

    p4r, p4i = [], []
    for b in range(J - 1):
        hi = bands[b + 1]  # widest correlating scale is c = b + 1
        era, eia = er[:, : b + 1, :hi], ei[:, : b + 1, :hi]
        erb, eib = er[:, b, :hi][:, None], ei[:, b, :hi][:, None]
        Sc = S[b + 1 :, :hi]                            # (J-1-b, hi)
        # C = ef_a * conj(ef_b)
        Cr = era * erb + eia * eib
        Ci = eia * erb - era * eib
        p4r.append(torch.einsum("bat,ct->bac", Cr, Sc).reshape(B, -1))
        p4i.append(torch.einsum("bat,ct->bac", Ci, Sc).reshape(B, -1))
    if p4r:
        p4r = torch.cat(p4r, dim=1)[:, perm4] * inv_T2
        p4i = torch.cat(p4i, dim=1)[:, perm4] * inv_T2
    else:
        p4r = p4i = x.new_zeros((B, 0))
    norm4 = sig[:, ta] * sig[:, tb]
    phi4_r, phi4_i = p4r / norm4, p4i / norm4

    # mean as a t-statistic (O(1), comparable to the other stats)
    norm_mean = mean * float(np.sqrt(np.float32(T))) / torch.sqrt(
        torch.clamp(var, min=1e-30))

    return torch.cat(
        [
            norm_mean[:, None],
            torch.log(torch.clamp(var[:, None], min=1e-30)),
            torch.log(torch.clamp(power, min=1e-30)),
            sparsity,
            flatness,
            phi3_r,
            phi3_i,
            phi4_r,
            phi4_i,
        ],
        dim=-1,
    ).to(torch.float32)


@dataclass
class ScatteringStats:
    """Named view over the flat statistic vector (averaged over a batch)."""

    J: int
    flat: np.ndarray  # (n_stats,)

    def _slices(self):
        J = self.J
        n_pairs = J * (J - 1) // 2
        n_trip = len(_index_triples(J)[0])
        ofs = {}
        i = 0
        for name, n in (
            ("mean", 1), ("logvar", 1), ("logpower", J), ("sparsity", J),
            ("flatness", J),
            ("phi3_re", n_pairs), ("phi3_im", n_pairs),
            ("phi4_re", n_trip), ("phi4_im", n_trip),
        ):
            ofs[name] = slice(i, i + n)
            i += n
        return ofs

    def _get(self, name):
        return self.flat[self._slices()[name]]

    #: series length used for the mean's t-statistic normalisation; set by
    #: analyze() so .mean can invert it (None -> return the t-statistic)
    T: int | None = None

    @property
    def mean(self) -> float:
        t_stat = float(self._get("mean")[0])
        if self.T is None:
            return t_stat
        return t_stat * np.sqrt(self.variance / self.T)

    @property
    def variance(self) -> float:
        return float(np.exp(self._get("logvar")[0]))

    def mean_spectrum(self) -> np.ndarray:
        """Per-scale power Phi_2(j), unit-variance normalised."""
        return np.exp(self._get("logpower"))

    def sparsity(self) -> np.ndarray:
        return np.asarray(self._get("sparsity"))

    def flatness(self) -> np.ndarray:
        """Per-scale envelope flatness ``<|W|^4> / <|W|^2>^2`` (2 for a
        Gaussian envelope; larger = heavier tails)."""
        return np.exp(self._get("flatness"))

    def phase_envelope(self) -> np.ndarray:
        """Phi_3 as a (J, J) complex matrix (a rows, b cols; a < b)."""
        J = self.J
        out = np.zeros((J, J), dtype=np.complex128)
        ia, ib = _index_pairs(J)
        out[ia, ib] = self._get("phi3_re") + 1j * self._get("phi3_im")
        return out

    def envelope_correlation(self) -> np.ndarray:
        """Phi_4 marginalised over the correlating scale c: (J, J) complex
        matrix over (a, b)."""
        J = self.J
        out = np.zeros((J, J), dtype=np.complex128)
        cnt = np.zeros((J, J))
        ta, tb, tc = _index_triples(J)
        vals = self._get("phi4_re") + 1j * self._get("phi4_im")
        np.add.at(out, (ta, tb), vals)
        np.add.at(cnt, (ta, tb), 1.0)
        with np.errstate(invalid="ignore"):
            out = np.where(cnt > 0, out / np.maximum(cnt, 1), 0.0)
        return out


def scattering_stats(x: Array, bank: FilterBank,
                     average: bool = True) -> torch.Tensor:
    """Flat statistic vector of ``x`` (``(B, T)`` or ``(T,)``), float32 on
    ``x``'s device (a numpy array is read on the CPU).

    :param average: average the per-sample vectors over the batch
    """
    x = torch.atleast_2d(as_tensor(x).to(torch.float32))
    psi = torch.as_tensor(bank.psi_hat, device=x.device)
    with fp32_exact():
        flat = _scattering_stats_flat(x, psi, J=bank.J,
                                      bands=bank.band_hi or None)
    return flat.mean(dim=0) if average else flat
