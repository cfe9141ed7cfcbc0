"""Static-capacity + validity-mask utilities (port of ``sfmx.core.masking``).

Fixed-capacity tensors with boolean ``alive`` masks keep every shape static,
so results compare slot by slot with the JAX reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k over the last axis with ``lax.top_k``'s tie rule.

    Equal values come out in ascending index order (the lower index wins),
    which ``torch.topk`` does not guarantee on CUDA.  A stable descending
    sort gives exactly that order.  Returns (values, int64 indices).
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k where only ``mask`` entries are eligible; returns
    (values, indices, valid) with valid = values > NEG_INF/2."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = topk_lowest_index(masked, k)
    return vals, idx, vals > NEG_INF / 2


def masked_argmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    val, idx = torch.max(masked, dim=dim)
    return val, idx, val > NEG_INF / 2


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim), min=1.0)

