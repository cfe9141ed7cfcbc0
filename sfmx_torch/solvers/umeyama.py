"""Closed-form similarity alignment (port of ``sfmx.solvers.umeyama``):
georeferencing and the absolute trajectory error."""
from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor, mask=None, with_scale: bool = True):
    """Least-squares similarity (s, R, t) minimizing ||dst - (s R src + t)||^2
    over (N,3) correspondences; mask (N,) bool selects the valid ones."""
    if mask is None:
        mask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    w = mask.to(src.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu_s = torch.sum(src * w[:, None], dim=0) / n
    mu_d = torch.sum(dst * w[:, None], dim=0) / n
    sc = (src - mu_s) * w[:, None]
    dc = (dst - mu_d) * w[:, None]
    cov = dc.T @ (src - mu_s) / n
    var_s = torch.sum(sc * (src - mu_s)) / n
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)])
    R = (U * S) @ Vt
    if with_scale:
        s = torch.sum(D * S) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_sim3(s, R, t, X):
    return s * (X @ R.T) + t


def ate_rmse(est: torch.Tensor, ref: torch.Tensor, mask=None, with_scale: bool = True):
    """Absolute trajectory error: Umeyama-align est to ref, RMSE of residuals.
    Returns (rmse, (s, R, t))."""
    if mask is None:
        mask = torch.ones(est.shape[0], dtype=torch.bool, device=est.device)
    s, R, t = umeyama(est, ref, mask, with_scale=with_scale)
    err2 = torch.sum((apply_sim3(s, R, t, est) - ref) ** 2, dim=-1)
    w = mask.to(est.dtype)
    rmse = torch.sqrt(torch.sum(err2 * w) / torch.clamp(torch.sum(w), min=1.0))
    return rmse, (s, R, t)
