"""Static-capacity + validity-mask utilities (port of ``sfmx.core.masking``).

Fixed-capacity tensors with boolean ``alive`` masks keep every shape static,
so results compare slot by slot with the JAX reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


def masked_argmin(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    v, i, ok = masked_argmax(-scores, mask, dim=dim)
    return -v, i, ok


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim), min=1.0)


def pad_axis_to(x: torch.Tensor, size: int, dim: int = 0, fill=0) -> torch.Tensor:
    """Pad (with ``fill``) or truncate one dimension to exactly ``size``."""
    n = x.shape[dim]
    if n >= size:
        return x.narrow(dim, 0, size)
    shape = list(x.shape)
    shape[dim] = size - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)


def first_free_slot(alive: torch.Tensor) -> torch.Tensor:
    """Index of the first False in a 1-D alive mask: the argmin of the mask,
    as the reference takes it, so a full mask gives 0, not its capacity."""
    return torch.argmin(alive.to(torch.int32))


def count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask.to(torch.int32), dtype=torch.int32)


def scatter_set(arr: torch.Tensor, idx, value, pred=True) -> torch.Tensor:
    """A copy of ``arr`` with ``arr[idx] = value`` where the boolean tensor
    (or bool) ``pred`` holds and the old entries elsewhere: a ``torch.where``
    on the device, no host sync."""
    old = arr[idx]
    pred = torch.as_tensor(pred, device=arr.device)
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    out = arr.clone()
    out[idx] = torch.where(pred, value, old)
    return out
