"""Exact k-smallest selection with a deterministic tie rule.

Port of the selection contract of :mod:`shadowing_tpu.ops.topk`: among equal
values the lower index wins (``lax.top_k``'s rule), and :func:`merge_min`
lets the earlier operand win ties. ``torch.topk`` does not promise either,
so both are a *stable* ascending sort followed by a slice. The block-min
tournament of the JAX module is not ported (selection cost on the card is
still to be measured).
"""
from __future__ import annotations

import torch


def topk_min(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest values of each row of ``scores (B, N)``, ascending,
    and their int64 column indices; ties go to the lower index."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds number of scores n={scores.shape[-1]}")
    vals, idx = torch.sort(scores, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_min(
    values_a: torch.Tensor,
    indices_a: torch.Tensor,
    values_b: torch.Tensor,
    indices_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact merge of two k-smallest partial results along the last axis;
    on equal values the earlier operand (``a``) wins."""
    v = torch.cat([values_a, values_b], dim=-1)
    i = torch.cat([indices_a, indices_b], dim=-1)
    vals, sel = topk_min(v, k)
    return vals, torch.gather(i, -1, sel)
