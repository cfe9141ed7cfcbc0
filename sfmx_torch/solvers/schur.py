"""Block-sparse normal equations and the Schur complement for bundle
adjustment (port of ``sfmx.solvers.schur``).

The observation table is the sparse structure: Jacobian blocks live per
observation, the normal-equation blocks are segment sums over camera or
point ids, and the Schur complement S = U - W V^-1 W^T is applied
matrix-free inside a block-Jacobi PCG.  Two pipelines are ported:

- PLANES: per-observation (O,18) W blocks, ``index_add_`` for the segment
  sums: small problems, CPU tensors, the merge's joint BA, the overflow
  observations of the dense path, and the pose/point part of the joint
  pose, point and intrinsics system (``NormalBlocksK``, ``pcg_k``) that
  ``lm.ba_solve_intrinsics`` solves; plain torch, as the reference has no
  kernel there.
- DENSE: the point-major slot layout of ``kernels/segsum`` with the fused
  kernels K7 (assembly) and K6 (the cross term of every matvec, the Schur
  rhs and the back-substitution).  Observations of tracks longer than the
  layout (overflow) ride the planes ops and are chained exactly into the
  kernel through its point-side bias and its camera-side output.

The reference's (O,2,6)/(O,6,3) block pipeline, its padded-row tables
(``SegmentRows``) and its track-blocked CG are not ported; its own tests
hold the planes pipeline equal to them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import segsum


def _damp(M: torch.Tensor, lam) -> torch.Tensor:
    """Levenberg multiplicative+additive damping of diagonal blocks (...,k,k)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * d + 1e-10)


def _inv3_components(a, b, c, d, e, f, g, h, i):
    """Adjugate inverse of 3x3 blocks given as 9 component tensors."""
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    return [x / det for x in (A, B, Cc, D, E, F, G, H, I)]


def _inv_spd(M: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batched SPD inverse with a Tikhonov floor: closed-form adjugate for
    3x3 blocks, 2x2-of-3x3 block Schur complement for 6x6 blocks, a batched
    inverse for other sizes (the intrinsics blocks)."""
    k = M.shape[-1]
    if k == 6:
        return _inv_spd6(M, eps)
    if k != 3:
        return torch.linalg.inv(M + eps * torch.eye(k, dtype=M.dtype, device=M.device))
    inv = _inv3_components(M[..., 0, 0] + eps, M[..., 0, 1], M[..., 0, 2],
                           M[..., 1, 0], M[..., 1, 1] + eps, M[..., 1, 2],
                           M[..., 2, 0], M[..., 2, 1], M[..., 2, 2] + eps)
    return torch.stack(inv, dim=-1).reshape(*M.shape[:-2], 3, 3)


def _inv_spd6(M: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """inv([[A,B],[Bt,D]]) = [[Ai + Ai B Si Bt Ai, -Ai B Si], [-Si Bt Ai, Si]]
    with S = D - Bt Ai B; both 3x3 inversions are the closed-form adjugate."""
    A, B = M[..., :3, :3], M[..., :3, 3:]
    Bt, D = M[..., 3:, :3], M[..., 3:, 3:]
    Ai = _inv_spd(A, eps)
    AiB = Ai @ B
    Si = _inv_spd(D - Bt @ AiB, eps)
    SiBtAi = Si @ (Bt @ Ai)
    top = torch.cat([Ai + AiB @ SiBtAi, -(AiB @ Si)], dim=-1)
    bot = torch.cat([-SiBtAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(O,...) rows summed by segment id -> (n,...)."""
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(
        0, ids.long(), x)


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N,a,b) blocks @ (N,b) -> (N,a)."""
    return (M @ v[..., None])[..., 0]


def _bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N,a,b) blocks^T @ (N,a) -> (N,b)."""
    return (v[..., None, :] @ M)[..., 0, :]


# ---------------------------------------------------------------------------
# PLANES pipeline
# ---------------------------------------------------------------------------


class NormalBlocksP(NamedTuple):
    U: torch.Tensor        # (C,6,6)
    V9: torch.Tensor       # (P,9) row-major 3x3 point blocks
    W18: torch.Tensor      # (O,18) row-major 6x3 coupling blocks
    b_c: torch.Tensor      # (C,6)
    b_p: torch.Tensor      # (P,3)
    cam_id: torch.Tensor
    pt_id: torch.Tensor


def assemble_planes(Jc, Jp, r, w, cam_id, pt_id, n_cams: int, n_pts: int) -> NormalBlocksP:
    """Normal blocks from planes-layout Jacobians (``lm._jacobians_planes``).

    Jc (O,12) = [du/d(w,t) | dv/d(w,t)]; Jp (O,6) = [du/dX | dv/dX]; r (O,2);
    w (O,) weights (0 for invalid rows, Huber weights otherwise).
    """
    Ju, Jv = Jc[:, :6], Jc[:, 6:]
    Pu, Pv = Jp[:, :3], Jp[:, 3:]
    ru, rv = r[:, 0:1], r[:, 1:2]
    wc = w[:, None]
    outer = lambda a, b: (a[:, :, None] * b[:, None, :]).flatten(1)
    U_o = wc * (outer(Ju, Ju) + outer(Jv, Jv))                      # (O,36)
    V_o = wc * (outer(Pu, Pu) + outer(Pv, Pv))                      # (O,9)
    W_o = wc * (outer(Ju, Pu) + outer(Jv, Pv))                      # (O,18)
    bc_o = -wc * (Ju * ru + Jv * rv)
    bp_o = -wc * (Pu * ru + Pv * rv)
    U = _segment_sum(U_o, cam_id, n_cams).reshape(n_cams, 6, 6)
    return NormalBlocksP(U, _segment_sum(V_o, pt_id, n_pts), W_o,
                         _segment_sum(bc_o, cam_id, n_cams), _segment_sum(bp_o, pt_id, n_pts),
                         cam_id, pt_id)


def _damp_inv3_rows(V9r: torch.Tensor, lam, eps: float = 1e-8) -> torch.Tensor:
    """(9, P) rows of 3x3 blocks -> (9, P) rows of their damped inverses."""
    k = 1.0 + lam
    inv = _inv3_components(V9r[0] * k + 1e-10 + eps, V9r[1], V9r[2],
                           V9r[3], V9r[4] * k + 1e-10 + eps, V9r[5],
                           V9r[6], V9r[7], V9r[8] * k + 1e-10 + eps)
    return torch.stack(inv, dim=0)


def _damp_inv3_planes(V9: torch.Tensor, lam, eps: float = 1e-8) -> torch.Tensor:
    """(P,9) damped 3x3 inverse -> (P,9)."""
    return _damp_inv3_rows(V9.T, lam, eps).T


def _mv3_planes(M9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N,9) 3x3 blocks @ (N,3) -> (N,3)."""
    return (M9.reshape(-1, 3, 3) @ v[:, :, None])[:, :, 0]


def _W_t_x(W18: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """(O,18) 6x3 blocks^T @ (O,6) -> (O,3)."""
    return (xg[:, None, :] @ W18.reshape(-1, 6, 3))[:, 0, :]


def _W_x(W18: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(O,18) 6x3 blocks @ (O,3) -> (O,6)."""
    return (W18.reshape(-1, 6, 3) @ v[:, :, None])[:, :, 0]


class SchurSystemP(NamedTuple):
    blocks: NormalBlocksP
    Vinv9: torch.Tensor    # (P,9)
    Ud: torch.Tensor       # (C,6,6)
    b_red: torch.Tensor    # (C,6)


def reduce_system_planes(nb: NormalBlocksP, lam) -> SchurSystemP:
    Ud = _damp(nb.U, lam)
    Vinv9 = _damp_inv3_planes(nb.V9, lam)
    Vinv_bp = _mv3_planes(Vinv9, nb.b_p)
    contrib = _W_x(nb.W18, Vinv_bp[nb.pt_id.long()])
    b_red = nb.b_c - _segment_sum(contrib, nb.cam_id, nb.U.shape[0])
    return SchurSystemP(nb, Vinv9, Ud, b_red)


def schur_matvec_planes(sys: SchurSystemP, x: torch.Tensor) -> torch.Tensor:
    nb = sys.blocks
    Ux = (sys.Ud @ x[:, :, None])[:, :, 0]
    y_p = _segment_sum(_W_t_x(nb.W18, x[nb.cam_id.long()]), nb.pt_id, sys.Vinv9.shape[0])
    Vy = _mv3_planes(sys.Vinv9, y_p)
    z_o = _W_x(nb.W18, Vy[nb.pt_id.long()])
    return Ux - _segment_sum(z_o, nb.cam_id, x.shape[0])


def solve_points_planes(sys: SchurSystemP, dx_c: torch.Tensor) -> torch.Tensor:
    nb = sys.blocks
    Wtx = _W_t_x(nb.W18, dx_c[nb.cam_id.long()])
    rhs = nb.b_p - _segment_sum(Wtx, nb.pt_id, sys.Vinv9.shape[0])
    return _mv3_planes(sys.Vinv9, rhs)


def _pcg(matvec, Ud: torch.Tensor, b_red: torch.Tensor, iters: int, fixed_cam_mask):
    """Block-Jacobi PCG on the reduced camera system; a fixed iteration
    count, and alpha/beta stay 0-d device tensors (no host sync per step)."""
    Minv = _inv_spd(Ud)

    def proj(x):
        if fixed_cam_mask is None:
            return x
        return torch.where(fixed_cam_mask[:, None], torch.zeros_like(x), x)

    def prec(r):
        return proj((Minv @ r[:, :, None])[:, :, 0])

    r = proj(b_red)
    x = torch.zeros_like(r)
    z = prec(r)
    p = z
    for _ in range(iters):
        Sp = proj(matvec(p))
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Sp
        z = prec(r)
        beta = torch.sum(r * z) / torch.clamp(rz, min=1e-20)
        p = z + beta * p
    return x, torch.sqrt(torch.sum(r * r))


def pcg_planes(sys: SchurSystemP, iters: int = 30, fixed_cam_mask=None):
    """Block-Jacobi PCG on the planes-layout reduced camera system."""
    return _pcg(lambda p: schur_matvec_planes(sys, p), sys.Ud, sys.b_red, iters, fixed_cam_mask)


# ---------------------------------------------------------------------------
# DENSE point-major pipeline: the fused kernels of kernels/segsum
# ---------------------------------------------------------------------------


class SchurSystemD(NamedTuple):
    """Reduced system in the dense point-major layout.

    cross: K6 bound to this system's W blocks (tp*18, P), layout and damped
    V^-1 (9, P), which it checks once for every matvec of the solve.
    ov_*: overflow observations, slots >= tp of tracks longer than the
    layout.  Their W^T x enters through K6's point-side bias and their W vy
    adds to its camera-side output; ``cross.Vinv9`` holds the damped inverses
    of the combined (dense + overflow) V, so the hybrid solve equals the
    unsplit one.
    """

    cross: segsum.SchurMatvec
    bp3: torch.Tensor       # (3, P) b_p
    Ud: torch.Tensor        # (C,6,6)
    b_red: torch.Tensor     # (C,6)
    ov_W18: torch.Tensor | None = None   # (Ov,18)
    ov_cam: torch.Tensor | None = None   # (Ov,)
    ov_pt: torch.Tensor | None = None    # (Ov,)


def _cross(sysd: SchurSystemD, x6: torch.Tensor, bias3):
    """K6 with the overflow observations chained in: (z6 (6,C), vy3 (3,P))."""
    P = sysd.cross.P
    if sysd.ov_W18 is not None:
        y_ov = _W_t_x(sysd.ov_W18, x6.T[sysd.ov_cam.long()])
        yp = _segment_sum(y_ov, sysd.ov_pt, P).T
        bias3 = yp.contiguous() if bias3 is None else bias3 + yp
    z6, vy3 = sysd.cross(x6, bias3)
    if sysd.ov_W18 is not None:
        z_ov = _W_x(sysd.ov_W18, vy3.T[sysd.ov_pt.long()])
        z6 = z6 + _segment_sum(z_ov, sysd.ov_cam, x6.shape[1]).T
    return z6, vy3


def reduce_system_fused(intr, k_idx, R, t, X, assemble: segsum.AssembleFused, lam,
                        delta: float, ov_blocks: NormalBlocksP | None = None, ov_cost=None):
    """One K7 pass (residuals, Jacobians, normal blocks) and the Schur
    reduction in the dense layout.  Returns (SchurSystemD, cost); the robust
    cost at the current parameters is a by-product of the assembly.

    ov_blocks / ov_cost: planes-assembled normal blocks and robust cost of
    the overflow observations; they fold into U, b_c, V and b_p here and
    their W blocks ride every later matvec.  ``assemble``: K7 bound to the
    dense layout and its packed observations once per solve.
    """
    C = R.shape[0]
    cam19 = segsum.build_cam_table(intr, k_idx, R, t)
    x3 = X.T.contiguous()
    U, b_c, v13, Wp = assemble(cam19, x3, delta)
    cost = torch.sum(v13[12])
    v9r, bpr = v13[:9], v13[9:12]
    ov = (None, None, None)
    if ov_blocks is not None:
        U = U + ov_blocks.U
        b_c = b_c + ov_blocks.b_c
        cost = cost + ov_cost
        v9r = v9r + ov_blocks.V9.T
        bpr = bpr + ov_blocks.b_p.T
        ov = (ov_blocks.W18, ov_blocks.cam_id, ov_blocks.pt_id)
    cross = segsum.SchurMatvec(Wp, assemble.dense, _damp_inv3_rows(v9r, lam).contiguous())
    sysd = SchurSystemD(cross, bpr.contiguous(), _damp(U, lam), b_c, *ov)
    # b_red = b_c - scatter_cam(W V^-1 b_p): the kernel with x = 0
    z6, _ = _cross(sysd, torch.zeros((6, C), dtype=torch.float32, device=R.device), sysd.bp3)
    return sysd._replace(b_red=b_c - z6.T), cost


def solve_points_dense(sysd: SchurSystemD, dx_c: torch.Tensor) -> torch.Tensor:
    """dx_p = V^-1 (b_p - W^T dx_c): the kernel with bias = -b_p.  (P,3)."""
    _, vy3 = _cross(sysd, dx_c.T.contiguous(), -sysd.bp3)
    return -vy3.T


def pcg_dense(sysd: SchurSystemD, iters: int = 30, fixed_cam_mask=None):
    """Block-Jacobi PCG with the fused dense-layout Schur matvec (K6)."""

    def matvec(x):
        z6, _ = _cross(sysd, x.T.contiguous(), None)
        return (sysd.Ud @ x[:, :, None])[:, :, 0] - z6.T

    return _pcg(matvec, sysd.Ud, sysd.b_red, iters, fixed_cam_mask)


# ---------------------------------------------------------------------------
# Extended system: shared-intrinsics blocks in the reduced camera system
# ---------------------------------------------------------------------------


class NormalBlocksK(NamedTuple):
    """Normal blocks with per-group intrinsics parameters (n_p each).

    Each camera couples to exactly one intrinsics group (k_idx[cam]), so the
    pose-intrinsics coupling is a per-camera (6,n_p) block and everything
    stays segment-sum shaped.
    """

    base: NormalBlocksP
    Ukk: torch.Tensor       # (I,n_p,n_p)
    Uck: torch.Tensor       # (C,6,n_p) pose-intrinsics coupling (summed per camera)
    Wk: torch.Tensor        # (O,n_p,3) intrinsics-point coupling per observation
    b_k: torch.Tensor       # (I,n_p)
    group: torch.Tensor     # (O,) intrinsics group of each observation
    cam_group: torch.Tensor  # (C,) intrinsics group of each camera


def assemble_with_intrinsics(Jc, Jp, Jk, r, w, cam_id, pt_id, group, cam_group,
                             n_cams: int, n_pts: int, n_groups: int) -> NormalBlocksK:
    """``assemble_planes`` of Jc (O,2,6), Jp (O,2,3) plus the intrinsics
    blocks of Jk (O,2,n_p)."""
    O = Jc.shape[0]
    base = assemble_planes(Jc.reshape(O, 12), Jp.reshape(O, 6), r, w, cam_id, pt_id,
                           n_cams, n_pts)
    ws = w[:, None, None]
    Jkt = (Jk * ws).transpose(1, 2)                       # (O,n_p,2)
    Ukk_o = Jkt @ Jk
    Uck_o = (Jc * ws).transpose(1, 2) @ Jk                # (O,6,n_p)
    Wk_o = Jkt @ Jp                                       # (O,n_p,3)
    bk_o = -(Jkt @ r[..., None])[..., 0]
    return NormalBlocksK(base, _segment_sum(Ukk_o, group, n_groups),
                         _segment_sum(Uck_o, cam_id, n_cams), Wk_o,
                         _segment_sum(bk_o, group, n_groups), group, cam_group)


class SchurSystemK(NamedTuple):
    sys: SchurSystemP        # pose/point part (damped, reduced)
    Ukk_d: torch.Tensor      # (I,n_p,n_p) damped
    Uck: torch.Tensor        # (C,6,n_p)
    Wk: torch.Tensor         # (O,n_p,3)
    b_red_k: torch.Tensor    # (I,n_p)
    group: torch.Tensor
    cam_group: torch.Tensor

    @property
    def n_groups(self) -> int:
        return self.Ukk_d.shape[0]


def reduce_system_k(nbk: NormalBlocksK, lam) -> SchurSystemK:
    sys = reduce_system_planes(nbk.base, lam)
    nb = nbk.base
    # b_red_k = b_k - Wk V^-1 b_p
    contrib = _bmv(nbk.Wk, _mv3_planes(sys.Vinv9, nb.b_p)[nb.pt_id.long()])
    b_red_k = nbk.b_k - _segment_sum(contrib, nbk.group, nbk.Ukk.shape[0])
    return SchurSystemK(sys, _damp(nbk.Ukk, lam), nbk.Uck, nbk.Wk, b_red_k, nbk.group,
                        nbk.cam_group)


def _point_rhs_k(sk: SchurSystemK, x_c, x_k) -> torch.Tensor:
    """Per point: sum over its observations of Wc^T x_cam + Wk^T x_group."""
    nb = sk.sys.blocks
    Wtx = _W_t_x(nb.W18, x_c[nb.cam_id.long()]) + _bmtv(sk.Wk, x_k[sk.group.long()])
    return _segment_sum(Wtx, nb.pt_id, sk.sys.Vinv9.shape[0])


def schur_matvec_k(sk: SchurSystemK, x_c: torch.Tensor, x_k: torch.Tensor):
    """Matvec of the reduced system over (poses, intrinsics groups)."""
    sys = sk.sys
    nb = sys.blocks
    cg = sk.cam_group.long()
    # direct terms
    y_c = _bmv(sys.Ud, x_c) + _bmv(sk.Uck, x_k[cg])
    y_k = _bmv(sk.Ukk_d, x_k) + _segment_sum(_bmtv(sk.Uck, x_c), cg, sk.n_groups)
    # point-mediated terms: z_p = V^-1 (Wc^T x_c + Wk^T x_k) per point
    Vz = _mv3_planes(sys.Vinv9, _point_rhs_k(sk, x_c, x_k))[nb.pt_id.long()]
    y_c = y_c - _segment_sum(_W_x(nb.W18, Vz), nb.cam_id, x_c.shape[0])
    y_k = y_k - _segment_sum(_bmv(sk.Wk, Vz), sk.group, sk.n_groups)
    return y_c, y_k


def solve_points_k(sk: SchurSystemK, dx_c: torch.Tensor, dx_k: torch.Tensor) -> torch.Tensor:
    """dx_p = V^-1 (b_p - Wc^T dx_c - Wk^T dx_k)."""
    return _mv3_planes(sk.sys.Vinv9, sk.sys.blocks.b_p - _point_rhs_k(sk, dx_c, dx_k))


def pcg_k(sk: SchurSystemK, iters: int = 30, fixed_cam_mask=None):
    """Block-Jacobi PCG on the (poses + intrinsics) reduced system; a fixed
    iteration count.  Returns (dx_c (C,6), dx_k (I,n_p))."""
    Minv_c = _inv_spd(sk.sys.Ud)
    Minv_k = _inv_spd(sk.Ukk_d)

    def proj(xc, xk):
        if fixed_cam_mask is None:
            return xc, xk
        return torch.where(fixed_cam_mask[:, None], torch.zeros_like(xc), xc), xk

    def prec(rc, rk):
        return _bmv(Minv_c, rc), _bmv(Minv_k, rk)

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    r = proj(sk.sys.b_red, sk.b_red_k)
    x = (torch.zeros_like(r[0]), torch.zeros_like(r[1]))
    z = proj(*prec(*r))
    p = z
    for _ in range(iters):
        Sp = proj(*schur_matvec_k(sk, *p))
        rz = dot(r, z)
        alpha = rz / torch.clamp(dot(p, Sp), min=1e-20)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r = (r[0] - alpha * Sp[0], r[1] - alpha * Sp[1])
        z = proj(*prec(*r))
        beta = dot(r, z) / torch.clamp(rz, min=1e-20)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
    return x
