"""DLT triangulation: two-view and masked N-view (port of
``sfmx.solvers.triangulate``).

Each track has up to V observing views (a static capacity with a mask); the
per-track 4x4 normal matrix is a masked sum over views, and its null vector
comes from ``linalg.smallest_eigvec_spd`` (Cholesky + inverse iteration),
batched over any leading dimensions.

The normal matrix of noiseless rays is exactly singular, and a relative
shift below f32's rounding of the pivots (~2.4e-7 of the trace) lets the
Cholesky break down, which would turn the point into the fallback vector.
The shift here is 1e-5 of the mean eigenvalue: it moves no eigenvector, and
the inverse iteration still contracts by (shift/4) / (lambda_1/trace) per
step, under 4e-3 for any track that passes the 1.5 degree parallax gate.
"""
from __future__ import annotations

import math

import torch

from .linalg import smallest_eigvec_spd

_SHIFT = 1e-5


def triangulate_nview(Ps: torch.Tensor, xns: torch.Tensor, mask: torch.Tensor):
    """Triangulate points from up to V views each.

    Ps (...,V,3,4) projections in normalized coords (P = [R|t]), xns
    (...,V,2), mask (...,V) bool.  Returns (X (...,3), ok (...)): ok needs
    at least 2 valid views.
    """
    w = mask.to(Ps.dtype)[..., None]
    r0 = (xns[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]) * w      # (...,V,4)
    r1 = (xns[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]) * w
    A = torch.cat([r0, r1], dim=-2)                                # (...,2V,4)
    Xh = smallest_eigvec_spd(A.transpose(-1, -2) @ A, shift=_SHIFT)
    w_h = Xh[..., 3:4]
    X = Xh[..., :3] / torch.where(torch.abs(w_h) < 1e-12, torch.full_like(w_h, 1e-12), w_h)
    return X, mask.sum(dim=-1) >= 2


triangulate_nview_b = triangulate_nview


def triangulate_two_view(R1, t1, R2, t2, xn1, xn2):
    """Two-view DLT of (N,2) normalized coords.  R2, t2 may carry leading
    batch dims (...,3,3)/(...,3), which X (...,N,3) and ok (...,N) then
    carry too.  ok = in front of both cameras."""
    P1 = torch.cat([R1, t1[..., None]], dim=-1)
    P2 = torch.cat([R2, t2[..., None]], dim=-1)                    # (...,3,4)
    lead = P2.shape[:-2]
    n = xn1.shape[0]
    Ps = torch.stack([P1.expand(*lead, 3, 4), P2], dim=-3)         # (...,2,3,4)
    Ps = Ps[..., None, :, :, :].expand(*lead, n, 2, 3, 4)
    xns = torch.stack([xn1, xn2], dim=1).expand(*lead, n, 2, 2)
    mask = torch.ones((*lead, n, 2), dtype=torch.bool, device=xn1.device)
    X, _ = triangulate_nview(Ps, xns, mask)
    ok = cheirality(R1, t1, X) & cheirality(R2, t2, X)
    return X, ok


def cheirality(R, t, X, min_depth=1e-4, max_depth=1e6):
    """Positive-depth test.  X (...,N,3); R (...,3,3), t (...,3) broadcast
    against X's leading dims."""
    z = (X @ R.transpose(-1, -2)[..., :, 2:3])[..., 0] + t[..., None, 2]
    return (z > min_depth) & (z < max_depth)


def parallax_deg(c1, c2, X):
    """Triangulation angle in degrees at X between camera centers c1, c2."""
    a = c1 - X
    b = c2 - X
    an = torch.linalg.vector_norm(a, dim=-1)
    bn = torch.linalg.vector_norm(b, dim=-1)
    cosang = torch.sum(a * b, dim=-1) / torch.clamp(an * bn, min=1e-12)
    return torch.acos(torch.clamp(cosang, -1.0, 1.0)) * (180.0 / math.pi)
