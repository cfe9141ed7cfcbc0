"""Halo exchange and ring accumulation for block-partitioned BA (port of
``sfmx.dist.halo``).

The reference builds its reduce-scatter from ``ppermute`` hops around the
mesh ring; that ring is its contract, not a design to copy: rank r ends
with chunk r of the sum over ranks.  NCCL and gloo run their own rings (or
trees) behind ``reduce_scatter`` and ``all_gather``, so these are thin
wrappers on the process group's collectives:

  * ``ring_reduce_scatter``: each rank holds (n*Cb, ...) in one layout and
    receives its fully summed (Cb, ...) chunk;
  * ``ring_all_reduce``: the reduce-scatter, then an all-gather;
  * ``halo_gather``: every rank contributes its (Hcap, ...) halo export
    (rows of its own landmarks that other ranks observe) and receives the
    whole (n, Hcap, ...) boundary set, in one all-gather.

The backends sum in their own order, not the reference's ring order, so
results agree with it within rounding, not bit for bit.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


# ``all_gather_into_tensor`` and ``reduce_scatter_tensor``: the names that
# torch 2.11 (which has no ``*_single``) and 2.13 (which deprecates these
# for ``all_gather_single`` / ``reduce_scatter_single``) both have
def _all_gather(out, x, group=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)


def _reduce_scatter(out, x, group=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """(m, ...) on every rank -> (n*m, ...), rank r's rows at [r*m, (r+1)*m)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of x (a new tensor; x is left as it was)."""
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reduce-scatter x ((n*Cb, ...) per rank, identical layout).

    Returns this rank's fully reduced chunk (Cb, ...): psum(x)[rank-th chunk].
    """
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} is not a multiple of the world size {n}")
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce built from reduce-scatter + all-gather (psum parity)."""
    return all_gather_cat(ring_reduce_scatter(x, group), group).reshape(x.shape)


def halo_gather(local_vals: torch.Tensor, halo_local_idx: torch.Tensor,
                halo_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Exchange boundary values: one all-gather.

    halo_local_idx: (Hcap,) local landmark rows this rank exports (pad 0).
    halo_mask: (Hcap,) validity of those rows (bool or 0/1).
    Returns the (n, Hcap, ...) gathered boundary values, pad rows zero.  The
    masks do not travel: they are the layout's, which every rank holds (the
    reference's second output is the stacked ``halo_mask``).
    """
    n = dist.get_world_size(group)
    hcap = halo_local_idx.shape[0]
    m = halo_mask.reshape((-1,) + (1,) * (local_vals.ndim - 1)).to(local_vals.dtype)
    export = local_vals[halo_local_idx.long()] * m
    return all_gather_cat(export, group).reshape(n, hcap, *local_vals.shape[1:])
