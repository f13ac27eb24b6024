"""Array conventions shared across the port.

Time series follow the ``(B, C, T)`` convention (batch, channels, time) of
:mod:`shadowing_tpu.array_types`; arrays are numpy on the host and
``torch.Tensor`` on a device. Placement is always explicit: nothing here
moves data to a device the caller did not name.
"""
from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def dim_bct(x: Array) -> Array:
    """Coerce ``x`` to the canonical ``(B, C, T)`` shape (1-d: one
    single-channel series; 2-d: a batch of single-channel series)."""
    if x.ndim == 1:
        return x[None, None, :]
    if x.ndim == 2:
        return x[:, None, :]
    if x.ndim == 3:
        return x
    raise ValueError(
        f"cannot coerce array of ndim={x.ndim} to (B, C, T); expected 1-3 dims"
    )


def as_torch_f32(x: Array, device) -> torch.Tensor:
    """A contiguous float32 tensor of ``x`` on ``device`` (no copy when it
    already is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def as_tensor(x: Array) -> torch.Tensor:
    """``x`` itself when it is a tensor, else a CPU tensor of it."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def as_numpy(x: Array) -> np.ndarray:
    """Materialise to host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; a CUDA device must exist — the port
    never moves a CUDA request to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False "
            "— pass device='cpu' explicitly to run on the CPU"
        )
    return device


@contextlib.contextmanager
def fp32_exact():
    """Full float32 for convolutions and matmuls inside the block.

    cuDNN convolutions default to TF32 (~1e-3 relative), which would break
    the exact rescore, the self-match at distance 0.0 and pass 2's 1e-5
    certification floor. The previous settings are restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
