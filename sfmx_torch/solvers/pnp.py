"""Perspective-n-Point: 6-point DLT + Gauss-Newton refine (port of ``sfmx.solvers.pnp``).

Every function takes arbitrary leading batch dimensions: the reference's
``vmap`` over queries and RANSAC hypotheses is written out as batch axes.
"""
from __future__ import annotations

import torch

from ..core import se3
from .linalg import smallest_eigvec_spd

MIN_SAMPLE = 6


def dlt_pnp(xn: torch.Tensor, X: torch.Tensor, mask: torch.Tensor):
    """Direct linear transform camera resection.

    xn (...,N,2) normalized coords, X (...,N,3) world points, mask (...,N).
    Returns (R (...,3,3), t (...,3)) world-to-camera with R in SO(3).
    """
    w = mask.to(X.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    muX = torch.sum(X * w[..., None], dim=-2) / n[..., None]
    Xc = X - muX[..., None, :]
    rms = torch.sqrt(torch.sum(torch.sum(Xc * Xc, dim=-1) * w, dim=-1) / n)
    sX = 1.0 / torch.clamp(rms, min=1e-12)
    Xs = Xc * sX[..., None, None]

    x, y = xn[..., 0:1], xn[..., 1:2]
    Xh = torch.cat([Xs, torch.ones_like(Xs[..., :1])], dim=-1)      # (...,N,4)
    zeros = torch.zeros_like(Xh)
    r0 = torch.cat([Xh, zeros, -x * Xh], dim=-1)                      # (...,N,12)
    r1 = torch.cat([zeros, Xh, -y * Xh], dim=-1)
    A = torch.cat([r0 * w[..., None], r1 * w[..., None]], dim=-2)    # (...,2N,12)
    AtA = A.transpose(-1, -2) @ A
    p = smallest_eigvec_spd(AtA)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :, :3]
    # scale/sign: M/s is a rotation, depths positive; ||sQ||_F = s*sqrt(3)
    scale = torch.linalg.matrix_norm(M) / (3.0 ** 0.5)
    depth = (Xs @ M[..., 2, :, None])[..., 0] + P[..., 2, 3:4]
    sign = torch.sign(torch.sum(depth * w, dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    f = sign / torch.clamp(scale, min=1e-12)
    R = se3.project_to_so3_fast(M * f[..., None, None])
    t_s = P[..., :, 3] * f[..., None]
    t = t_s / sX[..., None] - (R @ muX[..., None])[..., 0]
    return R, t


def dlt_pnp_minimal(xn: torch.Tensor, X: torch.Tensor):
    """Minimal-sample entry for RANSAC: all rows valid (shape (...,6,·))."""
    return dlt_pnp(xn, X, torch.ones(xn.shape[:-1], dtype=torch.bool, device=xn.device))


def pnp_residual(R, t, xn, X):
    """Normalized-coordinate reprojection residual (...,N,2).
    R (...,3,3), t (...,3), xn (...,N,2), X (...,N,3)."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return Xc[..., :2] / zsafe[..., None] - xn


def _residual_jacobian(R, t, xn, X, w):
    """Masked residual r (...,N,2) and its analytic Jacobian (...,N,2,6)
    with respect to the left perturbation delta = (dw, dt) at zero.

    dXc/d(dw) = -hat(R X), dXc/d(dt) = I; the projection's derivative is
    [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]] on the clamped depth, as
    ``jax.jacfwd`` of the reference's residual gives at delta = 0.
    """
    RX = X @ R.transpose(-1, -2)
    Xc = RX + t[..., None, :]
    z = Xc[..., 2]
    small = torch.abs(z) < 1e-9
    zsafe = torch.where(small, torch.full_like(z, 1e-9), z)
    r = (Xc[..., :2] / zsafe[..., None] - xn) * w[..., None]
    inv_z = 1.0 / zsafe
    dz = torch.where(small, torch.zeros_like(z), torch.ones_like(z))  # clamped depth is constant
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([inv_z, zero, -Xc[..., 0] * inv_z * inv_z * dz], dim=-1),
        torch.stack([zero, inv_z, -Xc[..., 1] * inv_z * inv_z * dz], dim=-1),
    ], dim=-2)                                                       # (...,N,2,3)
    dX = torch.cat([-se3.hat(RX), torch.eye(3, dtype=X.dtype, device=X.device)
                    .expand(*RX.shape[:-1], 3, 3)], dim=-1)         # (...,N,3,6)
    J = (Jp @ dX) * w[..., None, None]
    return r, J


def refine_pnp_gn(R, t, xn, X, mask, iters: int = 10, damping: float = 1e-6):
    """Fixed-iteration Gauss-Newton on SE(3) (left perturbation); a step is
    accepted only if it lowers the masked cost."""
    w = mask.to(X.dtype)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r0, J = _residual_jacobian(R, t, xn, X, w)
        J = J.flatten(-3, -2)                                        # (...,2N,6)
        r0 = r0.flatten(-2)                                          # (...,2N)
        H = J.transpose(-1, -2) @ J + damping * eye6
        g = (J.transpose(-1, -2) @ r0[..., None])[..., 0]
        delta = -torch.linalg.solve_ex(H, g)[0]
        R2, t2 = se3.perturb(R, t, delta)
        c0 = torch.sum(r0 * r0, dim=-1)
        r2 = pnp_residual(R2, t2, xn, X) * w[..., None]
        c2 = torch.sum(r2 * r2, dim=(-2, -1))
        better = c2 < c0
        R = torch.where(better[..., None, None], R2, R)
        t = torch.where(better[..., None], t2, t)
    return R, t
