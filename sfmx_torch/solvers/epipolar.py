"""Epipolar geometry (port of ``sfmx.solvers.epipolar``): the SVD-free
weighted 8-point, the essential-structure projection and Sampson scoring of
the geometric-verification path, and the SVD 8-point, the decomposition of E
and the relative pose of the reconstruction's two-view initializer.

RANSAC hypothesis generation does not need SVD accuracy, so the null vector
of each 8-point system comes from a damped Cholesky of the normal matrix
A^T W A plus inverse iteration, written as vector steps over a (B,9,9)
batch: a few hundred small ops for the whole batch, no linalg call.  The
squared conditioning costs ~3 f32 digits against a direct SVD; winners are
re-fit with the weighted variant and get the (s,s,0) structure once per
pair.  The two-view initializer scores few pairs and keeps the reference's
direct SVD of A (``eight_point``).
"""
from __future__ import annotations

import torch


def _chol9_solve(M: torch.Tensor, b: torch.Tensor, eps_rel: float = 1e-7) -> torch.Tensor:
    """Solve (M + eps*I) x = b for a batch of symmetric 9x9 systems.

    M (B,9,9) (lower triangle read), b (B,9) -> x (B,9).  eps =
    eps_rel * trace/9 + 1e-20 damps the (near-)singular normal matrix, and a
    pivot below 1e-30 is floored there, so the solve never breaks down.
    """
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = eps_rel * tr / 9.0 + 1e-20
    L = torch.zeros_like(M)
    for j in range(n):
        d = M[:, j, j] + eps - torch.sum(L[:, j, :j] * L[:, j, :j], dim=-1)
        inv = torch.rsqrt(torch.clamp(d, min=1e-30))
        L[:, j, j] = 1.0 / inv
        off = M[:, j + 1:, j] - torch.sum(L[:, j + 1:, :j] * L[:, j, None, :j], dim=-1)
        L[:, j + 1:, j] = off * inv[:, None]
    y = torch.zeros_like(b)
    for i in range(n):
        y[:, i] = (b[:, i] - torch.sum(L[:, i, :i] * y[:, :i], dim=-1)) / L[:, i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[:, i] = (y[:, i] - torch.sum(L[:, i + 1:, i] * x[:, i + 1:], dim=-1)) / L[:, i, i]
    return x


def eight_point_batch(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
                      n_iter: int = 2) -> torch.Tensor:
    """Weighted 8-point over a batch: (B,N,2),(B,N,2),(B,N) -> F (B,3,3).

    Hartley normalization, normal matrix M = A^T W A, and ``n_iter`` damped
    inverse-iteration steps (each one ``_chol9_solve``) recover the null
    direction.  ||F||_F = 1.  Works for minimal samples (N=8, w=1) and
    weighted least-squares refits alike; the rank-2 / essential structure
    is NOT enforced (callers enforce it on winners only).
    """
    w = w.to(x1.dtype)
    n = torch.clamp(torch.sum(w, dim=1), min=1.0)                      # (B,)

    def norm(x):
        mu = torch.sum(x * w[..., None], dim=1) / n[:, None]           # (B,2)
        xc = (x - mu[:, None, :]) * w[..., None]
        rms = torch.sqrt(torch.sum(xc * xc, dim=(1, 2)) / n)
        # rms floor 1e-4: a (near-)coincident degenerate sample would
        # otherwise scale coords by ~1e12 and overflow M in f32
        s = (2.0 ** 0.5) / torch.clamp(rms, min=1e-4)                  # (B,)
        return (x - mu[:, None, :]) * s[:, None, None], mu, s

    x1n, mu1, s1 = norm(x1)
    x2n, mu2, s2 = norm(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]                                  # (B,N)
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)                     # (B,N,9)
    M = (A * w[..., None]).transpose(1, 2) @ A                         # (B,9,9)
    B = x1.shape[0]
    v = torch.full((B, 9), 1.0 / 3.0, dtype=x1.dtype, device=x1.device)
    for _ in range(n_iter):
        v = _chol9_solve(M, v)
        v = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-30)
    # denormalize F = T2^T Fn T1 (T similarity transforms)
    Fn = v.reshape(B, 3, 3)

    def T(mu, s):
        t = torch.zeros((B, 3, 3), dtype=x1.dtype, device=x1.device)
        t[:, 0, 0] = s
        t[:, 1, 1] = s
        t[:, 0, 2] = -mu[:, 0] * s
        t[:, 1, 2] = -mu[:, 1] * s
        t[:, 2, 2] = 1.0
        return t

    F = T(mu2, s2).transpose(1, 2) @ Fn @ T(mu1, s1)
    return F * torch.rsqrt(torch.sum(F * F, dim=(1, 2), keepdim=True) + 1e-30)


def enforce_essential_batch(F: torch.Tensor) -> torch.Tensor:
    """(B,3,3) -> nearest essential matrices ((s,s,0) singular structure),
    scaled to unit Frobenius norm.  A non-finite F (a refit over an empty
    inlier set) gives a NaN E, as the reference's SVD does;
    ``torch.linalg.svd`` would raise on it, so such rows are zeroed for the
    SVD and set to NaN after it."""
    bad = ~torch.isfinite(F).all(dim=-1).all(dim=-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[:, None, None], 0.0, F))
    s = 0.5 * (S[:, 0] + S[:, 1])
    D = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    E = (U * D[:, None, :]) @ Vh
    E = E / torch.clamp(torch.linalg.matrix_norm(E), min=1e-12)[:, None, None]
    return torch.where(bad[:, None, None], torch.nan, E)


def sampson_error_batch(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Sampson distance, batched over hypotheses: F (...,3,3), x1/x2
    (...,N,2) broadcast against F's leading dims -> (...,N).  A vanishing
    denominator (the point at the epipole, or F = 0) REJECTS: inf."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Fp1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftp2 = torch.einsum("...ji,...nj->...ni", F, p2)
    num = torch.sum(p2 * Fp1, dim=-1) ** 2
    den = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return torch.where(den > 1e-18, num / torch.clamp(den, min=1e-18),
                       torch.full_like(num, torch.inf))


def sampson_error(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance of one F (3,3), (N,)."""
    return sampson_error_batch(F, x1, x2)


# ---------------------------------------------------------------------------
# Two-view initialization (the reconstruction path)
# ---------------------------------------------------------------------------


def _hartley_normalize(x: torch.Tensor, mask: torch.Tensor):
    """Similarity-normalize (...,N,2) points to zero mean and sqrt(2) RMS
    radius over the masked rows; returns (points, T (...,3,3))."""
    w = mask.to(x.dtype)[..., None]
    n = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)
    mu = torch.sum(x * w, dim=-2) / n[..., None]
    xc = (x - mu[..., None, :]) * w
    rms = torch.sqrt(torch.sum(xc * xc, dim=(-2, -1)) / n)
    s = (2.0 ** 0.5) / torch.clamp(rms, min=1e-12)
    T = torch.zeros((*x.shape[:-2], 3, 3), dtype=x.dtype, device=x.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mu[..., 0]
    T[..., 1, 2] = -s * mu[..., 1]
    T[..., 2, 2] = 1.0
    return (x - mu[..., None, :]) * s[..., None, None], T


def eight_point(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor,
                essential: bool = False) -> torch.Tensor:
    """Normalized 8-point by direct SVD: x1, x2 (...,N,2), mask (...,N) ->
    (...,3,3) M with x2^T M x1 = 0, of unit Frobenius norm.  ``essential``
    enforces the (s,s,0) singular structure, else rank 2.  A degenerate
    sample (non-finite system) gives the zero matrix, which Sampson scoring
    rejects."""
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    A = A * mask.to(A.dtype)[..., None]
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    A = torch.where(bad[..., None, None], 0.0, A)
    if A.shape[-2] < 9:                                    # full_matrices: 9 right vectors
        A = torch.cat([A, A.new_zeros((*A.shape[:-2], 9 - A.shape[-2], 9))], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    F = Vt[..., 8, :].reshape(*A.shape[:-2], 3, 3)
    F = T2.transpose(-1, -2) @ F @ T1
    # structure enforcement after denormalization: the Hartley similarities
    # do not commute with the singular-value structure
    U, D, Vt = torch.linalg.svd(torch.where(torch.isfinite(F), F, 0.0))
    if essential:
        s = 0.5 * (D[..., 0] + D[..., 1])
        D = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    else:
        D = torch.cat([D[..., :2], torch.zeros_like(D[..., :1])], dim=-1)
    F = (U * D[..., None, :]) @ Vt
    F = F / torch.clamp(torch.linalg.matrix_norm(F), min=1e-12)[..., None, None]
    return torch.where(bad[..., None, None], 0.0, F)


def decompose_essential(E: torch.Tensor):
    """E (3,3) -> the 4 candidate (R (4,3,3), t (4,3)) with ||t|| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([t, -t, t, -t])


def relative_pose_from_essential(E: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor,
                                 mask: torch.Tensor):
    """The (R, t) among E's 4 decompositions with the most points in front
    of both cameras.  Camera 1 is the identity; returns world-to-camera-2
    (R, t) with unit baseline, the winning count and the (N,3) points."""
    from .triangulate import triangulate_two_view

    Rs, ts = decompose_essential(E)
    X, ok = triangulate_two_view(torch.eye(3, dtype=E.dtype, device=E.device),
                                 torch.zeros(3, dtype=E.dtype, device=E.device),
                                 Rs, ts, xn1, xn2)                  # (4,N,3), (4,N)
    counts = torch.sum((ok & mask).to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    return Rs[best], ts[best], counts[best], X[best]
