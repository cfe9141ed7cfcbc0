"""Pinhole camera with radial distortion (port of ``sfmx.core.cameras``).

An intrinsics record is a flat length-7 vector ``[fx, fy, cx, cy, k1, k2, k3]``.
"""
from __future__ import annotations

import torch

FX, FY, CX, CY, K1, K2, K3 = range(7)
N_INTR = 7


def make_intrinsics(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, *, device) -> torch.Tensor:
    """One intrinsics record (7,) float32 on ``device``."""
    return torch.tensor([fx, fy, cx, cy, k1, k2, k3], dtype=torch.float32, device=device)


def distort_radial(k: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial distortion to normalized coords xn (...,2)."""
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    f = 1.0 + r2 * (k[..., K1:K1 + 1] + r2 * (k[..., K2:K2 + 1] + r2 * k[..., K3:K3 + 1]))
    return xn * f


def undistort_radial(k: torch.Tensor, xd: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert radial distortion by a fixed 8-iteration fixed-point loop.

    ``k`` is (7,) or broadcastable against ``xd``'s leading dims as (...,7).
    """
    k1, k2, k3 = k[..., K1:K1 + 1], k[..., K2:K2 + 1], k[..., K3:K3 + 1]
    xn = xd
    for _ in range(iters):
        r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
        f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xn = xd / f
    return xn


def project(k: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """World point(s) X (...,3) -> pixel coords (...,2) and depth (...,)."""
    Xc = X @ R.transpose(-1, -2) + t
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn = Xc[..., :2] / zsafe[..., None]
    xd = distort_radial(k, xn)
    uv = xd * k[..., FX:FY + 1] + k[..., CX:CY + 1]
    return uv, z


def pixel_to_normalized(k: torch.Tensor, uv: torch.Tensor,
                        undistort: bool = True) -> torch.Tensor:
    """Pixel coords (...,2) -> undistorted normalized camera coords (...,2)."""
    xd = (uv - k[..., CX:CY + 1]) / k[..., FX:FY + 1]
    if undistort:
        return undistort_radial(k, xd)
    return xd


def bearing(k: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords (...,2) -> unit bearing vectors in the camera frame (...,3)."""
    xn = pixel_to_normalized(k, uv)
    v = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def K_matrix(k: torch.Tensor) -> torch.Tensor:
    """3x3 calibration matrices (...,3,3) of records k (...,7) (distortion ignored)."""
    one, zero = torch.ones_like(k[..., FX]), torch.zeros_like(k[..., FX])
    return torch.stack([
        torch.stack([k[..., FX], zero, k[..., CX]], dim=-1),
        torch.stack([zero, k[..., FY], k[..., CY]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def reprojection_residual(k, R, t, X, uv_obs):
    """Pixel residual of X (...,3) seen by camera (k, R, t) against uv_obs
    (...,2); k (...,7), R (...,3,3), t (...,3) carry the same leading dims
    (one observation per row)."""
    Xc = (R @ X[..., None])[..., 0] + t
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xd = distort_radial(k, Xc[..., :2] / zsafe[..., None])
    return xd * k[..., FX:FY + 1] + k[..., CX:CY + 1] - uv_obs
