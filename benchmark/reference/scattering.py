"""Plain reference of the scattering-spectra statistics (arXiv:2204.10177)
and of their max-entropy synthesis, for the check of the generation cell.

The statistic vector Phi(x) of a series x, with ``W_j x`` its wavelet
transform at scale j, ``env_j = |W_j x|``, ``<.>`` the mean over time and
``sig_j = sqrt(<env_j^2>)``:

* mean        <x> sqrt(T) / sqrt(Var x)      (a t-statistic)
* variance    log Var x
* power       log <env_j^2> / Var x                           (J)
* sparsity    <env_j>^2 / <env_j^2>                           (J)
* flatness    log <env_j^4> - 2 log <env_j^2>                 (J)
* phase-env   <W_b(env_a) conj(W_b x)> / (sig_a sig_b), a < b, real and
              imaginary parts                        (J(J-1)/2 each)
* env-corr    <W_c(env_a) conj(W_c(env_b))> / (sig_a sig_b),
              a <= b < c, real and imaginary parts   (~J^3/6 each)

in that order, each group in the order its indices are listed (``c``
outermost for env-corr). Everything is computed in the time domain from
these definitions: no Parseval, no truncated bands. The filter bank is a
frozen copy of the construction of
``shadowing_tpu_torch.models.scattering.wavelets`` kept in float64, so a
later change to the port's filters does not move the reference.

The synthesis (:func:`synthesize`) is plain Adam on the per-seed mean
squared mismatch of Phi of each seed's standardised series, with the
optimiser settings the configuration states; it runs only as the control,
in TF32. It imports neither JAX, the JAX package nor anything of
``shadowing_tpu_torch``.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import Arith, exact_products, round_tf32

XI = 3.0 * np.pi / 4.0
SIGMA0 = 0.6 * XI
#: rows whose statistics are computed together (bounds device memory)
BLOCK = 16


def filter_bank(T: int, J: int) -> np.ndarray:
    """Analytic Morlet band-pass filters ``(J, T)`` float64 on the FFT
    frequency grid: centre ``XI / 2**j``, bandwidth ``SIGMA0 / 2**j``, no
    response at DC or on negative frequencies, Littlewood-Paley normalised
    with the closing Gaussian low-pass at scale ``2**J``."""
    if 2**J > T:
        raise ValueError(f"J={J} too deep for T={T}")
    omega = 2 * np.pi * np.fft.fftfreq(T)

    def morlet(w):
        main = np.exp(-((w - XI) ** 2) / (2 * SIGMA0**2))
        corr = np.exp(-(XI**2) / (2 * SIGMA0**2)) * np.exp(-(w**2) / (2 * SIGMA0**2))
        return (main - corr) * (w > 0)

    psi = np.stack([morlet(omega * 2**j) for j in range(J)])
    phi = np.exp(-(omega**2) / (2 * (XI / 2**J) ** 2))
    lp = phi**2 + 0.5 * (psi**2).sum(0)
    return psi / np.sqrt(lp.max())


def _q(x: torch.Tensor, arith: Arith) -> torch.Tensor:
    """``x`` as an operand of a product in ``arith``: float64 as it is,
    TF32 rounded (the gradient passes through the rounding unchanged)."""
    if arith.name != "tf32":
        return x
    d = x.detach()
    return x + (round_tf32(d) - d)


def _avg(a: torch.Tensor, b: torch.Tensor, arith: Arith) -> torch.Tensor:
    """``<a b>`` over the last axis, of rounded operands."""
    return (_q(a, arith) * _q(b, arith)).mean(dim=-1)


def _orders(J: int) -> tuple:
    """Index of each (a, b) pair in the c-major order the loop of
    :func:`stats` makes them, listed in the canonical a-major order."""
    made = [(a, c) for c in range(1, J) for a in range(c)]
    canon = [(a, b) for a in range(J) for b in range(a + 1, J)]
    return [made.index(p) for p in canon]


def stats(x: torch.Tensor, psi: torch.Tensor, arith: Arith) -> torch.Tensor:
    """Phi ``(S, n)`` of every row of ``x (S, T)`` with filters ``psi (J,
    T)``, in ``arith``'s dtype with its products' operands rounded."""
    x, psi = x.to(arith.torch_dtype), psi.to(arith.torch_dtype)
    S, T = x.shape
    J = psi.shape[0]
    mean = x.mean(dim=-1)
    xc = x - mean[:, None]
    var = _avg(xc, xc, arith)
    W = torch.fft.ifft(torch.fft.fft(xc, dim=-1)[:, None, :] * psi, dim=-1)
    env = W.abs()
    p2 = _avg(env, env, arith)
    sig = torch.sqrt(p2)
    env2 = env * env
    p4 = _avg(env2, env2, arith)
    ef = torch.fft.fft(env, dim=-1)
    p3r, p3i, p4r, p4i = [], [], [], []
    with exact_products():
        for c in range(1, J):
            # W_c(env_a) for every a < c
            V = torch.fft.ifft(ef[:, :c] * psi[c], dim=-1)           # (S, c, T)
            vr, vi = _q(V.real, arith), _q(V.imag, arith)
            wr = _q(W[:, c].real, arith)[..., None]
            wi = _q(W[:, c].imag, arith)[..., None]
            norm = sig[:, :c] * sig[:, c : c + 1]
            p3r.append((vr @ wr + vi @ wi)[..., 0] / T / norm)
            p3i.append((vi @ wr - vr @ wi)[..., 0] / T / norm)
            a, b = np.triu_indices(c)                               # a <= b < c
            gr = (vr @ vr.mT + vi @ vi.mT) / T
            gi = (vi @ vr.mT - vr @ vi.mT) / T
            norm = sig[:, a] * sig[:, b]
            p4r.append(gr[:, a, b] / norm)
            p4i.append(gi[:, a, b] / norm)
    order = _orders(J)
    cat = lambda parts: torch.cat(parts, dim=1) if parts else x.new_zeros((S, 0))
    return torch.cat([
        (mean * np.sqrt(T) / torch.sqrt(var))[:, None],
        torch.log(var)[:, None],
        torch.log(p2 / var[:, None]),
        env.mean(dim=-1) ** 2 / p2,
        torch.log(p4) - 2.0 * torch.log(p2),
        cat(p3r)[:, order], cat(p3i)[:, order], cat(p4r), cat(p4i),
    ], dim=1)


def standardize(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=-1, keepdim=True)
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True))


class Statistics:
    """Phi's target on an observed series and the per-seed RMS mismatch of
    synthesised series, in one arithmetic."""

    def __init__(self, series: np.ndarray, J: int, T: int, arith: Arith, device):
        self.J, self.T, self.arith, self.device = J, T, arith, torch.device(device)
        obs = torch.as_tensor(np.asarray(series, np.float64), device=self.device)
        self.psi = torch.as_tensor(filter_bank(T, J), device=self.device)
        psi_obs = torch.as_tensor(filter_bank(obs.numel(), J), device=self.device)
        #: Phi of the standardised observed series, ``(n,)``
        self.target = stats(standardize(obs[None]), psi_obs, arith)[0].detach()

    def loss(self, z: torch.Tensor) -> torch.Tensor:
        """Per-seed mean squared mismatch of Phi of each standardised row."""
        return ((stats(standardize(z), self.psi, self.arith) - self.target) ** 2).mean(dim=-1)

    def rms(self, paths) -> np.ndarray:
        """Per-row RMS mismatch ``(S,)`` float64 of ``paths (S, T)``, in
        blocks of :data:`BLOCK` rows."""
        paths = torch.as_tensor(np.asarray(paths, np.float64), device=self.device)
        with torch.no_grad():
            out = [torch.sqrt(self.loss(paths[i : i + BLOCK].to(self.arith.torch_dtype)))
                   for i in range(0, paths.shape[0], BLOCK)]
        return torch.cat(out).double().cpu().numpy()


def _lr(schedule, t: int) -> float:
    """Cosine ``lr0 -> lr1`` over ``horizon`` steps, then ``lr1``."""
    _, lr0, lr1, horizon = schedule
    return lr1 + 0.5 * (lr0 - lr1) * (1.0 + np.cos(np.pi * min(t / horizon, 1.0)))


def coloured_noise(gen: torch.Generator, batch: int, st: Statistics) -> torch.Tensor:
    """Unit normals shaped to the target's per-scale powers: the spectrum
    ``H^2 = sum_j u_j r_j`` with ``u_j = |psi_j|^2 / sum_k |psi_k|^2`` and
    ``r_j`` the target's power over white noise's, mirrored to the negative
    frequencies (1 where no filter reaches)."""
    S = (st.psi**2).double()
    J = st.J
    ratio = torch.exp(st.target[2 : 2 + J].double()) / S.mean(dim=-1)
    tot = S.sum(dim=0)
    h2 = torch.where(tot > 1e-12, (S / tot.clamp(min=1e-20) * ratio[:, None]).sum(0), 1.0)
    k = torch.arange(st.T, device=st.device)
    h = torch.sqrt(h2[torch.minimum(k, st.T - k)])
    z = torch.randn((batch, st.T), generator=gen, device=st.device, dtype=torch.float64)
    return standardize(torch.fft.ifft(torch.fft.fft(z) * h).real).to(st.arith.torch_dtype)


def synthesize(st: Statistics, gen: torch.Generator, batch: int, opt: dict,
               tol: float, max_iterations: int) -> tuple:
    """``batch`` series whose Phi matches the target: Adam on each seed
    from coloured noise, a first segment of ``opt["first_segment"]``
    steps and later ones of ``opt["later_segments"]`` on the seeds still at
    or above ``tol``, which retire at each segment's end. Returns the
    standardised series ``(batch, T)``, each one's RMS mismatch and the
    steps of the longest-running seed."""
    b1, b2, eps = opt["adam_b1"], opt["adam_b2"], opt["adam_eps"]
    z = coloured_noise(gen, batch, st)
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    rms = np.full(batch, np.inf)
    active = np.arange(batch)
    done = 0
    while done < max_iterations and active.size:
        n = min(opt["first_segment"] if done == 0 else opt["later_segments"],
                max_iterations - done)
        idx = torch.as_tensor(active, device=st.device)
        za, ma, va = z[idx], m[idx], v[idx]
        for t in range(done + 1, done + n + 1):
            leaf = za.detach().requires_grad_()
            with torch.enable_grad():
                (g,) = torch.autograd.grad(st.loss(leaf).sum(), leaf)
            ma = b1 * ma + (1 - b1) * g
            va = b2 * va + (1 - b2) * g * g
            za = za - _lr(opt["lr"], t) * (ma / (1 - b1**t)) / (
                torch.sqrt(va / (1 - b2**t)) + eps)
        with torch.no_grad():
            r = torch.sqrt(st.loss(za)).double().cpu().numpy()
        z[idx], m[idx], v[idx] = za.detach(), ma, va
        rms[active] = r
        done += n
        active = active[r >= tol]
    return standardize(z), rms, done
