"""Levenberg-Marquardt bundle adjustment over the flat observation table
(port of ``sfmx.solvers.lm``).

One LM iteration is assembly, Schur reduction, PCG, back-substitution and a
step-scaling line search with accept/reject.  The iteration count is fixed
and the loop is a Python loop; accept/reject and the damping update stay
``torch.where`` on device scalars, so a solve never waits for the device.

Gauge: the cameras of ``fixed_cam_mask`` are held fixed; the scale gauge is
controlled by LM damping.  The joint intrinsics solve
(``ba_solve_intrinsics``) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import cameras, se3
from ..kernels import segsum
from . import schur


class BAState(NamedTuple):
    R: torch.Tensor        # (C,3,3)
    t: torch.Tensor        # (C,3)
    X: torch.Tensor        # (P,3)
    lam: torch.Tensor      # () LM damping
    cost: torch.Tensor     # () robust cost at the current parameters


def _cam_rows(intr, k_idx, R, t, cam_id):
    """The 19 per-observation camera components (R flat, t, intrinsics)."""
    ci = cam_id.long()
    return list(torch.cat([R.reshape(-1, 9)[ci], t[ci], intr[k_idx.long()[ci]]], dim=1).T)


def _jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv):
    """Analytic focal-normalized residual and Jacobians in planes layout:
    r (O,2), Jc (O,12) = [du/d(w,t) | dv/d(w,t)], Jp (O,6) = [du/dX | dv/dX].
    The same projection model as the fused kernels (``segsum._proj_math``)."""
    g = _cam_rows(intr, k_idx, R, t, cam_id)
    Xf = X[pt_id.long()]
    ru, rv, aux = segsum._proj_math(g, Xf[:, 0], Xf[:, 1], Xf[:, 2], uv[:, 0], uv[:, 1])
    Ju, Jv, Pu, Pv = segsum._jac_rows(g, aux)
    return (torch.stack([ru, rv], dim=-1), torch.stack(Ju + Jv, dim=-1),
            torch.stack(Pu + Pv, dim=-1))


def huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss given squared residual norms."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-20))
    return torch.where(rn <= delta, torch.ones_like(rn), delta / rn)


def robust_cost(r2: torch.Tensor, w_valid: torch.Tensor, delta: float) -> torch.Tensor:
    rn = torch.sqrt(torch.clamp(r2, min=1e-20))
    rho = torch.where(rn <= delta, r2, delta * (2.0 * rn - delta))
    return 0.5 * torch.sum(rho * w_valid)


def _eval_cost(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, delta):
    ci = cam_id.long()
    ko = intr[k_idx.long()[ci]]
    f = 0.5 * (ko[:, 0] + ko[:, 1])
    r = cameras.reprojection_residual(ko, R[ci], t[ci], X[pt_id.long()], uv) / f[:, None]
    return robust_cost(torch.sum(r * r, dim=-1), w_valid, delta)


_ALPHAS = (1.0, 0.5, 0.25, 0.0625)


def ba_solve(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed_cam_mask, *,
             iters: int = 20, cg_iters: int = 30, huber_px: float = 4.0,
             init_lambda: float = 1e-4, tp_cap: int | None = None,
             return_lam: bool = False, dense_cg: bool = False, ov_cap: int = 0):
    """Run ``iters`` LM iterations; returns (R, t, X, costs[iters+1]), plus
    the final damping with ``return_lam``.

    intr (I,7), k_idx (C,) camera -> intrinsics, R (C,3,3), t (C,3), X (P,3),
    cam_id/pt_id (O,), uv (O,2), w_valid (O,) 0/1, fixed_cam_mask (C,) bool;
    all on one device.  ``huber_px`` is given in pixels and converted to the
    normalized-residual domain with the mean focal length.

    tp_cap=None takes the planes path.  dense_cg=True (needs tp_cap) runs
    the dense point-major layout on the fused kernels: per LM iteration K7
    once, K6 once for the Schur rhs, once per CG step and once for the
    back-substitution, K8 once for the four trial steps; K8 once per solve
    for the initial cost, so that every cost an LM step is judged by comes
    from the same arithmetic.  The first tp_cap observations of each point
    ride the kernels; with ov_cap > 0 the observations past slot tp_cap
    (overflow) ride the planes ops, chained exactly into the kernels.
    ov_cap = 0 with longer tracks present drops those observations, as the
    reference does: callers size tp_cap or pass ov_cap.
    """
    n_cams, n_pts = R.shape[0], X.shape[0]
    dev = X.device
    huber_n = huber_px / float(torch.mean(0.5 * (intr[:, 0] + intr[:, 1])))

    # sort by point once: the dense layout needs it, and no result depends
    # on the order (every use is a sum)
    perm = torch.argsort(pt_id, stable=True)
    cam_id, pt_id, uv, w_valid = cam_id[perm], pt_id[perm], uv[perm], w_valid[perm]
    dense = ov = None
    if dense_cg:
        if not tp_cap:
            raise ValueError("dense_cg requires tp_cap (track-length bound)")
        dense = segsum.build_dense_obs(pt_id, cam_id, n_pts, n_cams, tp_cap)
        # packed once per solve for K7 and K8, and K8 bound to it
        uvw = segsum.pack_rows(dense, torch.cat([uv, w_valid[:, None]], dim=1))
        cost_fused = segsum.CostFused(dense, uvw)
        if ov_cap:
            start = torch.searchsorted(pt_id, torch.arange(n_pts, device=dev, dtype=pt_id.dtype))
            slot = torch.arange(len(pt_id), device=dev) - start[pt_id.long()]
            ovi = torch.nonzero(slot >= tp_cap)[:, 0]
            if len(ovi) > ov_cap:
                raise ValueError(f"{len(ovi)} overflow observations exceed ov_cap={ov_cap}")
            if len(ovi):
                ov = (cam_id[ovi], pt_id[ovi], uv[ovi], w_valid[ovi])

    def cost_of(Rs, ts, Xs):
        """Robust cost of len(Rs) candidates, through K8 on the dense path."""
        if dense is None:
            return torch.stack([_eval_cost(intr, k_idx, Rc, tc, Xc, cam_id, pt_id, uv,
                                           w_valid, huber_n) for Rc, tc, Xc in zip(Rs, ts, Xs)])
        cam19s = torch.cat([segsum.build_cam_table(intr, k_idx, Rc, tc)
                            for Rc, tc in zip(Rs, ts)], dim=0)
        x3s = torch.cat([Xc.T for Xc in Xs], dim=0).contiguous()
        costs = cost_fused(cam19s, x3s, huber_n, nc=len(Rs))
        if ov is not None:
            costs = costs + torch.stack([_eval_cost(intr, k_idx, Rc, tc, Xc, *ov, huber_n)
                                         for Rc, tc, Xc in zip(Rs, ts, Xs)])
        return costs

    state = BAState(R, t, X, torch.as_tensor(init_lambda, dtype=X.dtype, device=dev),
                    cost_of([R], [t], [X])[0])
    alphas = torch.tensor(_ALPHAS, dtype=X.dtype, device=dev)
    costs = [state.cost]
    for _ in range(iters):
        R, t, X = state.R, state.t, state.X
        if dense is not None:
            ov_blocks = ov_cost = None
            if ov is not None:
                r_o, Jc_o, Jp_o = _jacobians_planes(intr, k_idx, R, t, X, *ov[:3])
                r2o = torch.sum(r_o * r_o, dim=-1)
                ov_blocks = schur.assemble_planes(Jc_o, Jp_o, r_o,
                                                  ov[3] * huber_weight(r2o, huber_n),
                                                  ov[0], ov[1], n_cams, n_pts)
                ov_cost = robust_cost(r2o, ov[3], huber_n)
            sysd, _ = schur.reduce_system_fused(intr, k_idx, R, t, X, dense, uvw, state.lam,
                                                huber_n, ov_blocks=ov_blocks, ov_cost=ov_cost)
            dx_c, _ = schur.pcg_dense(sysd, iters=cg_iters, fixed_cam_mask=fixed_cam_mask)
            dx_p = schur.solve_points_dense(sysd, dx_c)
        else:
            r, Jc, Jp = _jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv)
            w = w_valid * huber_weight(torch.sum(r * r, dim=-1), huber_n)
            nbp = schur.assemble_planes(Jc, Jp, r, w, cam_id, pt_id, n_cams, n_pts)
            sysp = schur.reduce_system_planes(nbp, state.lam)
            dx_c, _ = schur.pcg_planes(sysp, iters=cg_iters, fixed_cam_mask=fixed_cam_mask)
            dx_p = schur.solve_points_planes(sysp, dx_c)

        # Step-scaling line search: f32 assembly noise can corrupt the
        # step's components along flat (gauge / low-parallax) directions;
        # a few halvings recover the descent part (the noise penalty shrinks
        # as alpha^2, the real gain only as alpha).
        Rs, ts = se3.perturb_b(R, t, alphas[:, None, None] * dx_c)     # (4,C,3,3), (4,C,3)
        Xs = X + alphas[:, None, None] * dx_p
        trial_costs = cost_of(Rs, ts, Xs)
        best = torch.argmin(trial_costs)
        pick = lambda x: x[best[None]][0]       # a 1-d index: no host sync
        new_cost = pick(trial_costs)
        accept = new_cost < state.cost
        full_step = accept & (best == 0)
        lam2 = torch.where(full_step, state.lam * 0.33,
                           torch.where(accept, state.lam, state.lam * 4.0))
        state = BAState(torch.where(accept, pick(Rs), R), torch.where(accept, pick(ts), t),
                        torch.where(accept, pick(Xs), X), torch.clamp(lam2, 1e-9, 1e6),
                        torch.where(accept, new_cost, state.cost))
        costs.append(state.cost)
    out = (state.R, state.t, state.X, torch.stack(costs))
    return out + (state.lam,) if return_lam else out


def reprojection_rmse(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid):
    """Masked RMSE in pixels over the observation table (diagnostic)."""
    ci = cam_id.long()
    r = cameras.reprojection_residual(intr[k_idx.long()[ci]], R[ci], t[ci], X[pt_id.long()], uv)
    n = torch.clamp(torch.sum(w_valid), min=1.0)
    return torch.sqrt(torch.sum(torch.sum(r * r, dim=-1) * w_valid) / n)
