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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) skew -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of rotations (...,3,3) -> (...,3), safe near identity and
    near pi: the quaternion route, not the trace/arccos formula, which loses
    precision near pi in f32."""
    q = rot_to_quat(R)                                    # (w, x, y, z), w >= 0
    qw, qv = q[..., 0], q[..., 1:]
    nv = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(nv, qw)                     # axis = qv / |qv|
    scale = torch.where(nv < 1e-7, 2.0 / torch.clamp(qw, min=1e-7),
                        theta / torch.clamp(nv, min=1e-30))
    return scale[..., None] * qv


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (...,3,3) -> unit quaternions (...,4) (w,x,y,z)
    with w >= 0.  Branchless Shepperd's method: all four constructions,
    the one keyed on the largest of (trace, R00, R11, R22) kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidates, each scaled by 4 * component^2 (>= 0 before the clip)
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    sw = torch.sqrt(qw2 + _EPS * _EPS) * 2.0
    cw = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = torch.sqrt(qx2 + _EPS * _EPS) * 2.0
    cx = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = torch.sqrt(qy2 + _EPS * _EPS) * 2.0
    cy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1)
    sz = torch.sqrt(qz2 + _EPS * _EPS) * 2.0
    cz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)                          # (...,4,4)
    pick = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)  # first of ties
    q = torch.gather(cands, -2, pick[..., None, None].expand(*pick.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.sign(torch.where(q[..., :1] == 0.0, torch.ones_like(q[..., :1]), q[..., :1]))


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (...,4) (w,x,y,z) -> rotation matrices (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) exp: xi (...,6) = (w, v) -> (R (...,3,3), t = V(w) v (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(use_taylor, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return so3_exp(w), (V @ v[..., None])[..., 0]


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: (R (...,3,3), t (...,3)) -> xi (...,6) = (w, v)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    W = hat(w)
    # V^-1 = I - W/2 + (1/th^2)(1 - th sin / (2 (1 - cos))) W^2
    half = 0.5 * theta
    cot_term = torch.where(
        use_taylor, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-20))
        / (theta2 + _EPS * _EPS))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], dim=-1)


def perturb(R: torch.Tensor, t: torch.Tensor, delta: torch.Tensor):
    """Left-multiplicative local update: delta = (dw[3], dt[3])."""
    dR = so3_exp(delta[..., :3])
    return dR @ R, t + delta[..., 3:6]


# Every function here takes leading batch dimensions, so the reference's
# vmapped forms are the same functions.
so3_exp_b = so3_exp
so3_log_b = so3_log
quat_to_rot_b = quat_to_rot
rot_to_quat_b = rot_to_quat
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


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotations to (...,3,3) matrices (SVD orthogonalization, det +1)."""
    U, _, Vt = torch.linalg.svd(M)
    d = det3(U @ Vt)
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return U @ S @ Vt


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
