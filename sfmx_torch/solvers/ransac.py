"""Batched-hypothesis RANSAC (port of ``sfmx.solvers.ransac``).

All minimal samples are drawn and scored at once: a static number of
hypotheses, a batched minimal solver, one (hypotheses x data) scoring pass,
argmax.  The hypothesis axis is a batch dimension; any leading dimensions
(e.g. a query batch) ride along.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.masking import topk_lowest_index


def gumbel_noise(shape, *, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """iid standard Gumbel noise drawn from ``generator`` on ``device``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_minimal(gumbel: torch.Tensor, mask: torch.Tensor, sample_size: int) -> torch.Tensor:
    """Gumbel-top-k sampling without replacement among valid indices.

    gumbel (...,k_hyp,n) noise, mask (...,n) -> (...,k_hyp,sample_size)
    int64 indices.  The noise is an input so a test can inject the
    reference's ``jax.random.gumbel`` draw.
    """
    scores = torch.where(mask[..., None, :], gumbel,
                         torch.full_like(gumbel, -torch.inf))
    return topk_lowest_index(scores, sample_size)[1]


def ransac(gumbel: torch.Tensor, solver: Callable, residual_fn: Callable,
           data: tuple, mask: torch.Tensor, *, sample_size: int,
           inlier_threshold: float | torch.Tensor, n_candidates: int = 1):
    """Generic batched RANSAC.

    gumbel: (...,k_hyp,N) sampling noise (see ``gumbel_noise``).
    solver: (sampled data (...,k_hyp,s,·) ...) -> model tuple with leading
      (...,k_hyp) axes.  With n_candidates > 1 the solver returns leading
      (...,k_hyp,n_candidates) axes (multi-root minimal solvers like P3P);
      all candidates join the hypothesis axis and argmax selects across them.
    residual_fn: (model, data...) -> (...,N) residuals; ``model`` carries
      either (...,k_hyp) or (...) leading axes and data (...,N,·) — the
      function broadcasts the hypothesis axis itself.
    data: tuple of (...,N,·) tensors; mask (...,N) valid correspondences.
    inlier_threshold: a float, or a tensor of the leading shape (...) — one
      threshold per batch entry (e.g. per-query focal lengths).

    Returns (best_model, inlier_mask (...,N), best_count (...)).
    """
    idx = sample_minimal(gumbel, mask, sample_size)             # (...,k,s)
    k_hyp = idx.shape[-2]

    def gather(d):
        lead = d.shape[:-2]
        flat = idx.reshape(*lead, k_hyp * sample_size)
        g = torch.gather(d, -2, flat[..., None].expand(*flat.shape, d.shape[-1]))
        return g.reshape(*lead, k_hyp, sample_size, d.shape[-1])

    models = solver(*(gather(d) for d in data))
    if n_candidates > 1:
        nl = idx.ndim - 1                                         # leading axes + k_hyp
        models = tuple(x.reshape(*x.shape[:nl - 1], k_hyp * n_candidates, *x.shape[nl + 1:])
                       for x in models)
    thr_k = thr_n = inlier_threshold
    if isinstance(inlier_threshold, torch.Tensor):
        thr_k, thr_n = inlier_threshold[..., None, None], inlier_threshold[..., None]
    r = residual_fn(models, *(d[..., None, :, :] for d in data))  # (...,k,N)
    inl = (r < thr_k) & mask[..., None, :]
    counts = torch.sum(inl.to(torch.int32), dim=-1)              # (...,k)
    best = torch.argmax(counts, dim=-1)                           # first max

    def pick(x):
        sel = best.reshape(*best.shape, *([1] * (x.ndim - best.ndim)))
        return torch.take_along_dim(x, sel, dim=best.ndim).squeeze(best.ndim)

    best_model = tuple(pick(x) for x in models)
    r = residual_fn(best_model, *data)
    inliers = (r < thr_n) & mask
    best_count = torch.take_along_dim(counts, best[..., None], dim=-1)[..., 0]
    return best_model, inliers, best_count
