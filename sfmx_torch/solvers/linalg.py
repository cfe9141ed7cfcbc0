"""Small-matrix linear algebra for batched use (port of ``sfmx.solvers.linalg``)."""
from __future__ import annotations

import torch


def smallest_eigvec_spd(A: torch.Tensor, iters: int = 6, shift: float = 1e-8,
                        exact_fallback: bool = False) -> torch.Tensor:
    """Smallest eigenvector of symmetric PSD matrices (...,n,n) by inverse
    iteration: one Cholesky + ``iters`` triangular solves.

    Cholesky breakdown does not raise: ``cholesky_ex`` reports it per
    matrix, and a broken or non-finite result becomes the deterministic
    start vector ``v0`` (in RANSAC such a hypothesis scores no inliers).
    With ``exact_fallback`` those matrices, and only those, take the
    eigenvector of a full ``eigh`` instead (the reference's default; its
    RANSAC callers pass False, and so do the port's by default).
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
    M = A + (shift * tr + 1e-20)[..., None, None] * eye
    L, info = torch.linalg.cholesky_ex(M)
    v0 = torch.full(A.shape[:-1], 1.0 / n ** 0.5, dtype=A.dtype, device=A.device)
    v = v0
    for _ in range(iters):
        y = torch.cholesky_solve(v[..., None], L)[..., 0]
        v = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-30)
    bad = (info != 0) | ~torch.isfinite(v).all(dim=-1)
    if not exact_fallback:
        return torch.where(bad[..., None], v0, v)
    # the reference's eigh on the broken matrices only; a non-finite one
    # gives NaN there, where torch's eigh would raise
    Ab = A[bad]
    finite = torch.isfinite(Ab).flatten(-2).all(dim=-1)
    w = torch.linalg.eigh(torch.where(finite[:, None, None], Ab, eye))[1][..., :, 0]
    v = v.clone()
    v[bad] = torch.where(finite[:, None], w, torch.full_like(w, torch.nan))
    return v
