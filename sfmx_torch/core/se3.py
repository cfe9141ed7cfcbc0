"""SO(3)/SE(3) operations of the PnP, reconstruction and bundle-adjustment
paths (port of ``sfmx.core.se3``).

Conventions as in the reference: rotations are world-to-camera 3x3
matrices ``R`` and ``X_cam = R @ X + t``; tangent updates act on the LEFT,
``R' = exp(w) @ R``.  Every function takes arbitrary leading batch
dimensions (the reference's ``vmap`` written out).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe near theta=0. (...,3) -> (...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def perturb(R: torch.Tensor, t: torch.Tensor, delta: torch.Tensor):
    """Left-multiplicative local update: delta = (dw[3], dt[3])."""
    dR = so3_exp(delta[..., :3])
    return dR @ R, t + delta[..., 3:6]


# Every function here takes leading batch dimensions, so the reference's
# vmapped forms are the same functions.
so3_exp_b = so3_exp
perturb_b = perturb


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def apply(R, t, X):
    """Transform world point(s) X (...,3) into the camera frame of one (R, t)."""
    return X @ R.transpose(-1, -2) + t


def det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (...,3,3)."""
    return torch.sum(M[..., :, 0] * torch.linalg.cross(M[..., :, 1], M[..., :, 2]), dim=-1)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via adjugate (branch-free, mul/add only)."""
    c0 = torch.linalg.cross(M[..., :, 1], M[..., :, 2])
    c1 = torch.linalg.cross(M[..., :, 2], M[..., :, 0])
    c2 = torch.linalg.cross(M[..., :, 0], M[..., :, 1])
    adjT = torch.stack([c0, c1, c2], dim=-2)  # rows = cofactor columns
    det = torch.sum(M[..., :, 0] * c0, dim=-1)
    det = torch.where(torch.abs(det) < 1e-30, torch.sign(det) * 1e-30 + 1e-30, det)
    return adjT / det[..., None, None]


def project_to_so3_fast(M: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """SVD-free nearest rotation: scaled Higham polar iteration.

    X <- (g X + (g X)^-T) / 2 with g = |det X|^(-1/3).  Reflections are
    flipped first so the result has det=+1; a non-finite result (degenerate
    input) becomes the identity, which scores no inliers.
    """
    sign = torch.where(det3(M) < 0, -1.0, 1.0).to(M.dtype)
    X = M * sign[..., None, None]
    for _ in range(iters):
        d = torch.abs(det3(X))
        g = torch.pow(torch.clamp(d, min=1e-30), -1.0 / 3.0)
        Xg = X * g[..., None, None]
        X = 0.5 * (Xg + _inv3(Xg).transpose(-1, -2))
    finite = torch.isfinite(X).flatten(-2).all(dim=-1)
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand_as(X)
    return torch.where(finite[..., None, None], X, eye)
