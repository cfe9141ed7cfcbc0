"""Observation-sharded Levenberg-Marquardt bundle adjustment over a process
group (port of ``sfmx.dist.dist_ba``).

  * The observation table (the only O(N) axis) is split over the ranks.
    Residuals, Jacobians, robust weights and every per-observation outer
    product are rank-local: no communication.
  * The fixed-size reduced quantities (camera blocks U (C,6,6), point blocks
    V (P,3,3), the right-hand sides) are the planes pipeline's local
    fixed-order segment sums (``schur.assemble_planes``) plus one all-reduce
    of all four, packed into one buffer.
  * PCG on the reduced camera system runs replicated; its matvec's
    observation terms are local segment sums, each followed by one
    all-reduce.
  * Camera and point states stay replicated (tiny next to the table).

The reference assembles through its (O,2,6) block pipeline, which the port
does not carry (``solvers/schur``); the planes pipeline computes the same
blocks.  Every rank decides accept/reject from the same all-reduced costs,
so the ranks' control flow never parts.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..solvers import lm as lm_mod
from ..solvers import schur as schur_mod
from .halo import all_reduce_sum


def shard_rows(x, rank: int, world_size: int):
    """Rank ``rank``'s contiguous rows of an (n*m, ...) array (its block of
    the mesh axis); the length must divide (``mesh.pad_to_multiple``)."""
    n = x.shape[0]
    if n % world_size:
        raise ValueError(f"{n} rows do not split over {world_size} ranks")
    m = n // world_size
    return x[rank * m:(rank + 1) * m]


def ba_step_local(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed, *,
                  iters: int = 10, cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """The LM loop on this rank: ``cam_id``, ``pt_id``, ``uv``, ``w_valid``
    are this rank's rows of the table (pad rows w = 0); the rest replicated.
    Returns (R, t, X, costs[iters+1]), replicated."""
    n_cams, n_pts = R.shape[0], X.shape[0]
    dev = X.device
    huber_n = huber_px / float(torch.mean(0.5 * (intr[:, 0] + intr[:, 1])))
    cp, pp = schur_mod.segment_plan(cam_id, n_cams), schur_mod.segment_plan(pt_id, n_pts)
    ci, pi = cp.ids, pp.ids
    seg = schur_mod.segment_sum

    def cost_of(Rs, ts, Xs):
        local = torch.stack([lm_mod._eval_cost(intr, k_idx, Rc, tc, Xc, cam_id, pt_id, uv,
                                               w_valid, huber_n)
                             for Rc, tc, Xc in zip(Rs, ts, Xs)])
        return all_reduce_sum(local, group)

    state = lm_mod.BAState(R, t, X, torch.as_tensor(1e-4, dtype=X.dtype, device=dev),
                           cost_of([R], [t], [X])[0])
    alphas = torch.tensor(lm_mod._ALPHAS, dtype=X.dtype, device=dev)
    costs = [state.cost]
    for _ in range(iters):
        R, t, X = state.R, state.t, state.X
        r, Jc, Jp = lm_mod._jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv)
        w = w_valid * lm_mod.huber_weight(torch.sum(r * r, dim=-1), huber_n)
        nb = schur_mod.assemble_planes(Jc, Jp, r, w, cp, pp)
        # local assembly + one all-reduce of the fixed-size blocks
        packed = all_reduce_sum(torch.cat([nb.U.reshape(-1), nb.b_c.reshape(-1),
                                           nb.V9.reshape(-1), nb.b_p.reshape(-1)]), group)
        U, b_c, V9, b_p = torch.split(packed, [n_cams * 36, n_cams * 6, n_pts * 9, n_pts * 3])
        U, b_c = U.reshape(n_cams, 6, 6), b_c.reshape(n_cams, 6)
        V9, b_p = V9.reshape(n_pts, 9), b_p.reshape(n_pts, 3)
        W18 = nb.W18

        Ud = schur_mod._damp(U, state.lam)
        Vinv9 = schur_mod._damp_inv3_planes(V9, state.lam)
        Vinv_bp = schur_mod._mv3_planes(Vinv9, b_p)
        b_red = b_c - all_reduce_sum(seg(schur_mod._W_x(W18, Vinv_bp[pi]), cp), group)

        def matvec(x):
            Ux = (Ud @ x[:, :, None])[:, :, 0]
            y_p = all_reduce_sum(seg(schur_mod._W_t_x(W18, x[ci]), pp), group)
            Vy = schur_mod._mv3_planes(Vinv9, y_p)
            z_c = all_reduce_sum(seg(schur_mod._W_x(W18, Vy[pi]), cp), group)
            return Ux - z_c

        dx_c, _ = schur_mod._pcg(matvec, Ud, b_red, cg_iters, fixed)
        # back-substitute points (replicated): the global W^T dx_c per point
        rhs = b_p - all_reduce_sum(seg(schur_mod._W_t_x(W18, dx_c[ci]), pp), group)
        dx_p = schur_mod._mv3_planes(Vinv9, rhs)
        state = lm_mod.lm_step(state, dx_c, dx_p, cost_of, alphas)
        costs.append(state.cost)
    return state.R, state.t, state.X, torch.stack(costs)


def make_ba_step(*, iters: int = 10, cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """The observation-sharded BA solver of the current process group.

    The returned ``step(intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed)``
    takes the whole table, padded to a multiple of the world size with dead
    rows (w = 0, ``mesh.pad_to_multiple``), on every rank, as the
    reference's step takes the global arrays; each rank solves on its
    contiguous block of rows.  Returns (R, t, X, costs), replicated.
    """
    def step(intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed):
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        rows = [shard_rows(a, rank, n) for a in (cam_id, pt_id, uv, w)]
        return ba_step_local(intr, k_idx, R, t, X, *rows, fixed, iters=iters,
                             cg_iters=cg_iters, huber_px=huber_px, group=group)

    return step
