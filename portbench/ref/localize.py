"""Plain localization: the reference the serving cells are held to.

The same operations as the port's streaming path (``localize_batch_
streaming``: each query keypoint's best and second-best landmark over the
whole pool, Lowe's ratio and an absolute similarity floor, then 6-point DLT
RANSAC and a Gauss-Newton refine of the best hypothesis on its inliers),
written from the description and not from the port's code: scores in
float32 with TF32 off on the benchmark's own landmark descriptors, the
geometry in float64 numpy, the RANSAC samples from numpy's generator.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -3.0e38


def landmark_descriptors(feat_desc: np.ndarray, obs_cam, obs_feat, obs_pt, P: int) -> np.ndarray:
    """Each landmark's descriptor: the mean of its observations' keyframe
    descriptors, L2-normalized.  (P,D) float32."""
    d = feat_desc[obs_cam, obs_feat].astype(np.float64)
    out = np.zeros((P, feat_desc.shape[-1]), np.float64)
    np.add.at(out, obs_pt, d)
    out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out.astype(np.float32)


def top2(q: torch.Tensor, lm: torch.Tensor, *, chunk: int = 1 << 18, cast=None):
    """Best score, its landmark and the second-best score of every row of q
    (N,D) over lm (P,D), by full f32 products (TF32 off).  ``cast`` rounds
    both sides first (the control's lower precision).  Ties go to the lower
    index."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if cast is not None:
            q, lm = cast(q), cast(lm)
        N = q.shape[0]
        s1 = torch.full((N,), NEG, dtype=torch.float32, device=q.device)
        s2 = s1.clone()
        i1 = torch.zeros(N, dtype=torch.int64, device=q.device)
        for j0 in range(0, lm.shape[0], chunk):
            sim = q @ lm[j0:j0 + chunk].T
            v, i = torch.topk(sim, min(2, sim.shape[1]), dim=1)
            # lowest index among exact ties of the chunk's best
            first = torch.argmax((sim == v[:, :1]).to(torch.int8), dim=1)
            t1 = v[:, 0]
            t2 = v[:, 1] if v.shape[1] > 1 else torch.full_like(t1, NEG)
            take = t1 > s1
            s2 = torch.maximum(torch.minimum(s1, t1), torch.maximum(s2, t2))
            i1 = torch.where(take, first + j0, i1)
            s1 = torch.maximum(s1, t1)
        return s1, i1, s2
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def accept(s1, s2, mask, ratio: float, sim_thresh: float):
    """Lowe's ratio on the distances 2 - 2 s and the similarity floor."""
    d1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    return (d1 < ratio * ratio * d2) & (s1 > sim_thresh) & mask


def normalized(uv: np.ndarray, intr: np.ndarray) -> np.ndarray:
    return (uv.astype(np.float64) - intr[2:4]) / intr[0:2]


def residual2(R, t, xn, X):
    """Squared normalized reprojection residuals; R (...,3,3), t (...,3),
    xn (N,2), X (N,3) -> (...,N)."""
    Xc = np.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = np.where(np.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    r = Xc[..., :2] / z[..., None] - xn
    return np.sum(r * r, axis=-1)


def _nearest_rotation(M):
    U, _s, Vt = np.linalg.svd(M)
    d = np.sign(np.linalg.det(U @ Vt))
    U[..., :, 2] *= d[..., None]
    return U @ Vt


def dlt(xn, X):
    """6-point (or more) DLT resection, batched: xn (...,n,2), X (...,n,3)
    -> R (...,3,3), t (...,3), world to camera."""
    mu = X.mean(axis=-2, keepdims=True)
    Xc = X - mu
    s = 1.0 / np.maximum(np.sqrt(np.mean(np.sum(Xc * Xc, -1), -1)), 1e-12)
    Xs = Xc * s[..., None, None]
    Xh = np.concatenate([Xs, np.ones_like(Xs[..., :1])], -1)
    z = np.zeros_like(Xh)
    x, y = xn[..., 0:1], xn[..., 1:2]
    A = np.concatenate([np.concatenate([Xh, z, -x * Xh], -1),
                        np.concatenate([z, Xh, -y * Xh], -1)], -2)
    _w, V = np.linalg.eigh(np.swapaxes(A, -1, -2) @ A)
    P = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    M = P[..., :, :3]
    scale = np.linalg.norm(M, axis=(-2, -1)) / np.sqrt(3.0)
    depth = np.einsum("...nj,...j->...n", Xs, M[..., 2, :]) + P[..., 2, 3:4]
    sign = np.sign(np.sum(depth, -1))
    sign = np.where(sign == 0, 1.0, sign)
    f = sign / np.maximum(scale, 1e-12)
    R = _nearest_rotation(M * f[..., None, None])
    t = P[..., :, 3] * f[..., None] / s[..., None] - np.einsum("...ij,...j->...i", R, mu[..., 0, :])
    return R, t


def _hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp(w):
    th = np.linalg.norm(w)
    K = _hat(w)
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * (K @ K)


def refine(R, t, xn, X, iters: int = 20):
    """Gauss-Newton on SE(3) (left perturbation) over the given
    correspondences, a step kept only where it lowers the cost; float64."""
    R, t = R.astype(np.float64), t.astype(np.float64)
    cost = residual2(R, t, xn, X).sum()
    for _ in range(iters):
        RX = X @ R.T
        Xc = RX + t
        z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        r = (Xc[:, :2] / z[:, None] - xn).reshape(-1)
        Jp = np.zeros((len(X), 2, 3))
        Jp[:, 0, 0] = Jp[:, 1, 1] = 1.0 / z
        Jp[:, 0, 2] = -Xc[:, 0] / z ** 2
        Jp[:, 1, 2] = -Xc[:, 1] / z ** 2
        dX = np.concatenate([-_hat(RX), np.broadcast_to(np.eye(3), (len(X), 3, 3))], -1)
        J = (Jp @ dX).reshape(-1, 6)
        delta = -np.linalg.solve(J.T @ J + 1e-12 * np.eye(6), J.T @ r)
        R2, t2 = _exp(delta[:3]) @ R, t + delta[3:]
        c2 = residual2(R2, t2, xn, X).sum()
        if not c2 < cost:
            break
        R, t, cost = R2, t2, c2
    return R, t


def ransac_pnp(xn, X, ok, *, k_hypotheses: int, thresh2: float, rng, sample: int = 6):
    """Best of k DLT hypotheses on random minimal samples of the accepted
    correspondences by inlier count, refined on its inliers and counted
    again.  Returns (R, t, n_inliers) or None where fewer than ``sample``
    correspondences are accepted."""
    idx = np.flatnonzero(ok)
    if len(idx) < sample:
        return None
    xs, Xs = xn[idx], X[idx]
    pick = np.argsort(rng.random((k_hypotheses, len(idx))), axis=1)[:, :sample]
    R, t = dlt(xs[pick], Xs[pick])
    n_in = np.sum(residual2(R, t, xs, Xs) < thresh2, axis=1)
    b = int(np.argmax(n_in))
    inl = residual2(R[b], t[b], xs, Xs) < thresh2
    R1, t1 = refine(R[b], t[b], xs[inl], Xs[inl])
    return R1, t1, int(np.sum(residual2(R1, t1, xs, Xs) < thresh2))


def center(R, t):
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
