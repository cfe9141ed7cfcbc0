"""Closed-form similarity alignment (port of ``sfmx.solvers.umeyama``):
georeferencing, the absolute trajectory error, and the minimal solver of the
similarity RANSAC in ``recon/register``.  Every function takes leading batch
dimensions (the reference's ``vmap`` written out)."""
from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor, mask=None, with_scale: bool = True):
    """Least-squares similarity (s, R, t) minimizing ||dst - (s R src + t)||^2
    over (...,N,3) correspondences; mask (...,N) bool selects the valid ones.
    Returns s (...), R (...,3,3), t (...,3)."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device)
    w = mask.to(src.dtype)[..., None]
    n = torch.clamp(torch.sum(w, dim=-2), min=1.0)                 # (...,1)
    mu_s = torch.sum(src * w, dim=-2) / n
    mu_d = torch.sum(dst * w, dim=-2) / n
    src_c = src - mu_s[..., None, :]
    cov = ((dst - mu_d[..., None, :]) * w).transpose(-1, -2) @ src_c / n[..., None]
    var_s = torch.sum(src_c * w * src_c, dim=(-2, -1)) / n[..., 0]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(det.shape, dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def apply_sim3(s, R, t, X):
    """s R X + t for X (...,N,3) under similarities of leading shape (...)."""
    s = torch.as_tensor(s, dtype=X.dtype, device=X.device)
    return s[..., None, None] * (X @ R.transpose(-1, -2)) + t[..., None, :]


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
