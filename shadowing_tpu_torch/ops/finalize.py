"""Finalize's reads of the k winners out of ``y``, keyed by their flat ids
``traj * n_out + t``: ``csrc/finalize_gather.cu``.

* :func:`gather_embed`: each winner's input window embedded where it lies,
  ``(B, k, d)``, with no ``(B, k, C, w)`` copy of the windows;
* :func:`extract_windows`: each whole window copied once, ``(B, k, C,
  w_extract)``, with no int64 position tensor;
* :func:`embed_windows`: whole windows ``(..., C, w)`` embedded, through
  :func:`gather_embed`'s kernel on a CUDA tensor (every window a row of its
  own), so a context and a dataset window equal to it embed to bit-equal
  vectors on the card as on the CPU.

On a CUDA tensor each wrapper launches its kernel (counters
``launch.gather_embed``, ``launch.extract_windows``); on a CPU tensor it
runs the plain PyTorch version. There is no fallback between the two. The
kernel sums every window from 0, channel by channel and tap by tap, one
``fmaf`` each; the plain :func:`embed_windows_plain` sums PyTorch's way, so
the two agree to float32 rounding, and each device agrees with itself bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from shadowing_tpu_torch.ops._build import Kernel, check_tensor, ptr

GATHER_EMBED = Kernel("gather_embed", [ctypes.c_void_p] * 5
                      + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6)
EXTRACT = Kernel("extract_windows", [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4)


def embed_windows_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``(..., C, w) -> (..., d)``: the elementwise product with the
    ``(d, C, w)`` bank and its sum over ``(C, w)``."""
    return (x.unsqueeze(-3) * kernel).sum(dim=(-2, -1))


def extract_windows_plain(src: torch.Tensor, ids: torch.Tensor, n_out: int,
                          w_extract: int) -> torch.Tensor:
    """The windows gathered from ``src``'s sliding view."""
    return src.unfold(-1, w_extract, 1)[ids // n_out, :, ids % n_out]


def gather_embed_plain(src: torch.Tensor, ids: torch.Tensor, n_out: int,
                       in_pos: torch.Tensor, kernel: torch.Tensor
                       ) -> torch.Tensor:
    """The windows' input samples gathered, then :func:`embed_windows_plain`."""
    win = extract_windows_plain(src[:, : kernel.shape[1]], ids, n_out,
                                int(in_pos.max()) + 1)
    return embed_windows_plain(win[..., in_pos], kernel)


def gather_embed(src: torch.Tensor, ids: torch.Tensor, n_out: int,
                 in_pos: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Embeddings ``(B, k, d)`` of the windows at the flat ids:
    ``e[b, j, i] = sum_c sum_tau src[traj, c, t0 + in_pos[tau]] *
    kernel[i, c, tau]`` with ``traj, t0 = divmod(ids[b, j], n_out)``.

    :param src: ``(R, Cs, T)`` trajectories; the bank reads the first ``C``
        channels
    :param ids: ``(B, k)`` int64 flat ids
    :param in_pos: ``(w,)`` int64 positions of the input samples inside a
        window, ascending, every ``t0 + in_pos`` below ``T``
    :param kernel: ``(d, C, w)`` embedding bank
    """
    dev = src.device
    check_tensor(src, "src", 3, dev)
    check_tensor(ids, "ids", 2, dev, torch.int64)
    check_tensor(in_pos, "in_pos", 1, dev, torch.int64)
    check_tensor(kernel, "kernel", 3, dev)
    R, Cs, T = src.shape
    d, C, w = kernel.shape
    if C > Cs or in_pos.numel() != w or not 1 <= n_out <= T:
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, kernel "
                         f"{tuple(kernel.shape)}, in_pos {in_pos.numel()}, "
                         f"n_out {n_out}")
    if dev.type == "cpu":
        return gather_embed_plain(src, ids, n_out, in_pos, kernel)
    if dev.type != "cuda":
        raise ValueError(f"no gather_embed kernel for device {dev}")
    B, k = ids.shape
    e = torch.empty((B, k, d), dtype=torch.float32, device=dev)
    if ids.numel():
        GATHER_EMBED.launch(ptr(src), ptr(ids), ptr(in_pos), ptr(kernel),
                            ptr(e), B * k, R * n_out, Cs, T, n_out, C, w, d)
    return e


def extract_windows(src: torch.Tensor, ids: torch.Tensor, n_out: int,
                    w_extract: int) -> torch.Tensor:
    """Windows ``(B, k, C, w_extract)`` of ``src (R, C, T)`` at the flat
    ids ``(B, k)`` int64: exact slices ``src[traj, :, t0 : t0 +
    w_extract]``."""
    dev = src.device
    check_tensor(src, "src", 3, dev)
    check_tensor(ids, "ids", 2, dev, torch.int64)
    R, C, T = src.shape
    if not (w_extract >= 1 and n_out >= 1 and n_out + w_extract - 1 <= T):
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, n_out "
                         f"{n_out}, w_extract {w_extract}")
    if dev.type == "cpu":
        return extract_windows_plain(src, ids, n_out, w_extract)
    if dev.type != "cuda":
        raise ValueError(f"no extract_windows kernel for device {dev}")
    B, k = ids.shape
    out = torch.empty((B, k, C, w_extract), dtype=torch.float32, device=dev)
    if ids.numel():
        EXTRACT.launch(ptr(src), ptr(ids), ptr(out), B * k, R * n_out, C, T,
                       n_out, w_extract)
    return out


def embed_windows(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Embed whole windows ``(..., C, w) -> (..., d)``.

    Every window is reduced in the same order whatever its position in the
    batch, so equal windows embed to bit-equal vectors: the context and a
    dataset window equal to it rescore to a distance of exactly 0.0, and
    duplicated windows tie exactly. On a CUDA tensor one launch of
    :func:`gather_embed`'s kernel embeds them, each window a row of its
    own (``n_out = 1``; no id or position tensor: window n is id n, tap
    tau sample tau), the reduction the winners embed with; on a CPU tensor
    :func:`embed_windows_plain`."""
    if x.device.type != "cuda":
        return embed_windows_plain(x, kernel)
    C, w = x.shape[-2:]
    src, kernel = x.reshape(-1, C, w).contiguous(), kernel.contiguous()
    check_tensor(src, "x", 3, x.device)
    check_tensor(kernel, "kernel", 3, x.device)
    d = kernel.shape[0]
    if kernel.shape[1:] != (C, w):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}")
    N = src.shape[0]
    e = torch.empty((N, d), dtype=torch.float32, device=x.device)
    if N:
        GATHER_EMBED.launch(ptr(src), None, None, ptr(kernel), ptr(e), N, N,
                            C, w, 1, C, w, d)
    return e.reshape(*x.shape[:-2], d)
