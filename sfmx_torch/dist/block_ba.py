"""Point-sharded distributed bundle adjustment over a process group (port of
``sfmx.dist.block_ba``: the config-4/5 scale path).

The map's long axis (trajectory blocks of cameras and their landmarks) is
split over the ranks (``dist.block_layout`` builds the layout): every rank
owns 1/n of the cameras, points and observations, and per LM iteration
only the covisibility boundary (halo) travels:

  LM iteration:   1 all-gather of halo point positions (Hcap,3)
                  1 reduce-scatter of packed halo V/b_p partials (Hcap,12)
                  1 all-gather of halo V^-1 b_p values (Hcap,3)
  CG iteration:   1 reduce-scatter (Hcap,3) + 1 all-gather (Hcap,3)
                  + 2 scalar all-reduces
  back-subst:     1 reduce-scatter (Hcap,3)
  line search:    1 all-gather (Hcap,3) + one all-reduce of the 4 costs

The block algebra is the planes formulation of ``solvers.schur``; the
camera-side reductions are rank-local, because observations live with
their camera's block; every segment sum is ``schur``'s fixed-order one over
plans built once per solve.  Every rank decides accept/reject from the same
all-reduced costs, so the ranks' control flow never parts.

Each rank calls the solvers with the same global arrays (as the
reference's callers hand the whole problem to one jitted step); each
builds the same layout, takes its own block, and gets the global result
back.  Pad cameras are held fixed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core import cameras, se3
from ..solvers import ba_ckpt
from ..solvers import lm as lm_mod
from ..solvers import schur as schur_mod
from ..solvers.intrinsics import _delta_to_intr
from . import halo as halo_mod
from .block_layout import (BlockLayout, build_block_layout, gather_cams, gather_pts,
                           scatter_cams, scatter_pts)


class _Shard:
    """The rank-local reductions and gathers of a block solve (shared by the
    pose-only and the joint-intrinsics LM), with their segment plans built
    once."""

    def __init__(self, cb: int, pb: int, n: int, hcap: int, cam_l, pt_ext, halo_idx,
                 halo_mask, group):
        self.cb, self.pb, self.n, self.hcap, self.group = cb, pb, n, hcap, group
        self.cam_plan = schur_mod.segment_plan(cam_l, cb)
        self.ext_plan = schur_mod.segment_plan(pt_ext, pb + n * hcap)
        self.cam_l, self.pt_ext = self.cam_plan.ids, self.ext_plan.ids
        self.halo_idx = halo_idx.long()
        # the export slots in use: each names a distinct local point
        slots = torch.nonzero(halo_mask)[:, 0]
        self.slots, self.slot_rows = slots, self.halo_idx[slots]
        self.halo_w = halo_mask.to(torch.float32)

    def gather_ext(self, v):
        """Per-owned-point values extended with every block's halo exports
        (one all-gather)."""
        g = halo_mod.halo_gather(v, self.halo_idx, self.halo_w, self.group)
        return torch.cat([v, g.reshape(self.n * self.hcap, *v.shape[1:])], dim=0)

    def reduce_pt(self, vals):
        """(Ob,d) observation values -> (Pb,d) at their owners: a local
        segment sum over the extended index space, then the halo part
        (sums this block made for points owned elsewhere) reduce-scattered,
        so each owner receives the summed partials of its exported points."""
        seg = schur_mod.segment_sum(vals, self.ext_plan)
        local, halo_part = seg[:self.pb], seg[self.pb:]
        recv = halo_mod.ring_reduce_scatter(halo_part, self.group)            # (Hcap,d)
        rows = self.slot_rows
        return local.index_copy(0, rows, local[rows] + recv[self.slots])

    def reduce_cam(self, vals):
        """Observations live with their camera's block: rank-local."""
        return schur_mod.segment_sum(vals, self.cam_plan)

    def dot(self, a, b):
        return halo_mod.all_reduce_sum(torch.sum(a * b), self.group)


def block_lm_local(intr, lam0, k_idx, R, t, X, fixed, cam_l, pt_ext, uv, w_valid, halo_idx,
                   halo_mask, *, n_blocks: int, hcap: int, iters: int = 10,
                   cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """The pose-and-point LM on this rank's block.

    Rank-local shapes: R (Cb,3,3), t (Cb,3), X (Pb,3), fixed/k_idx (Cb,),
    cam_l/pt_ext/uv/w (Ob,...), halo_idx/halo_mask (Hcap,); intr (I,7) and
    lam0 replicated.  ``pt_ext`` indexes [local points | halo slots]:
    [0,Pb) local, Pb + b*Hcap + s the s-th export of block b.
    Returns (R, t, X, costs[iters+1], lam): the block's state, the costs and
    the final damping (replicated), so a chunked caller resumes the trust
    region."""
    cb, pb = R.shape[0], X.shape[0]
    dev = X.device
    f_ref = float(torch.mean(0.5 * (intr[:, 0] + intr[:, 1])))
    huber_n = huber_px / f_ref
    sh = _Shard(cb, pb, n_blocks, hcap, cam_l, pt_ext, halo_idx, halo_mask, group)
    ci, pe = sh.cam_l, sh.pt_ext
    ko = intr[k_idx.long()[ci]]

    def local_cost(Rc, tc, Xext):
        r = lm_mod._residual_one(ko, Rc[ci], tc[ci], Xext[pe], uv)
        return lm_mod.robust_cost(torch.sum(r * r, dim=-1), w_valid, huber_n)

    state = lm_mod.BAState(R, t, X, torch.as_tensor(lam0, dtype=X.dtype, device=dev).reshape(()),
                           halo_mod.all_reduce_sum(local_cost(R, t, sh.gather_ext(X)), group))
    alphas = torch.tensor(lm_mod._ALPHAS, dtype=X.dtype, device=dev)
    costs = [state.cost]
    for _ in range(iters):
        R, t, X, lam = state.R, state.t, state.X, state.lam
        Xext = sh.gather_ext(X)                                        # AG (Hcap,3)
        r, Jc, Jp = lm_mod._jacobians_planes(intr, k_idx, R, t, Xext, cam_l, pt_ext, uv)
        w = w_valid * lm_mod.huber_weight(torch.sum(r * r, dim=-1), huber_n)
        U_o, V_o, W18, bc_o, bp_o = schur_mod.planes_terms(Jc, Jp, r, w)
        U = sh.reduce_cam(U_o).reshape(cb, 6, 6)
        b_c = sh.reduce_cam(bc_o)
        Vbp = sh.reduce_pt(torch.cat([V_o, bp_o], dim=-1))             # RS (Hcap,12)
        V9, b_p = Vbp[:, :9], Vbp[:, 9:]

        Ud = schur_mod._damp(U, lam)
        Vinv9 = schur_mod._damp_inv3_planes(V9, lam)
        Vinv_bp_ext = sh.gather_ext(schur_mod._mv3_planes(Vinv9, b_p))  # AG (Hcap,3)
        b_red = b_c - sh.reduce_cam(schur_mod._W_x(W18, Vinv_bp_ext[pe]))

        def matvec(x):
            Ux = (Ud @ x[:, :, None])[:, :, 0]
            y_p = sh.reduce_pt(schur_mod._W_t_x(W18, x[ci]))          # RS (Hcap,3)
            Vy_ext = sh.gather_ext(schur_mod._mv3_planes(Vinv9, y_p))  # AG (Hcap,3)
            return Ux - sh.reduce_cam(schur_mod._W_x(W18, Vy_ext[pe]))

        dx_c, _ = schur_mod._pcg(matvec, Ud, b_red, cg_iters, fixed, dot=sh.dot)
        # back-substitute owned points: dx_p = V^-1 (b_p - W^T dx_c)
        rhs = b_p - sh.reduce_pt(schur_mod._W_t_x(W18, dx_c[ci]))       # RS (Hcap,3)
        dx_p = schur_mod._mv3_planes(Vinv9, rhs)
        dxp_ext = sh.gather_ext(dx_p)                                  # AG (Hcap,3)

        def cost_of(Rs, ts, _Xs):
            # the candidates' points with their halo copies, one all-reduce
            return halo_mod.all_reduce_sum(torch.stack(
                [local_cost(Rs[i], ts[i], Xext + a * dxp_ext) for i, a in enumerate(alphas)]),
                group)

        state = lm_mod.lm_step(state, dx_c, dx_p, cost_of, alphas)
        costs.append(state.cost)
    return state.R, state.t, state.X, torch.stack(costs), state.lam


def block_lm_local_k(intr, lam0, k_idx, R, t, X, fixed, cam_l, pt_ext, uv, w_valid,
                     halo_idx, halo_mask, *, params: tuple, n_blocks: int, hcap: int,
                     iters: int = 10, cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """The joint pose, point and INTRINSICS LM on this rank's block (the
    distributed ``lm.ba_solve_intrinsics``).  Intrinsics groups are
    replicated state: their normal blocks (Ukk, b_k) and every
    intrinsics-side reduction in CG are summed over ranks, while the pose
    and point sides keep the pose-only solver's locality.  Returns
    (intr, R, t, X, costs[iters+1], lam)."""
    cb, pb = R.shape[0], X.shape[0]
    dev = X.device
    n_groups = intr.shape[0]
    f_ref = float(torch.mean(0.5 * (intr[:, 0] + intr[:, 1])))
    huber_n = huber_px / f_ref
    sh = _Shard(cb, pb, n_blocks, hcap, cam_l, pt_ext, halo_idx, halo_mask, group)
    ci, pe = sh.cam_l, sh.pt_ext
    kl = k_idx.long()
    gidx = kl[ci]
    group_plan = schur_mod.segment_plan(gidx, n_groups)
    cam_group_plan = schur_mod.segment_plan(kl, n_groups)

    def reduce_group(vals):          # (Ob,...) -> (I,...), summed over ranks
        return halo_mod.all_reduce_sum(schur_mod.segment_sum(vals, group_plan), group)

    def reduce_cam_group(vals):      # (Cb,...) -> (I,...), summed over ranks
        return halo_mod.all_reduce_sum(schur_mod.segment_sum(vals, cam_group_plan), group)

    def local_cost(intr_c, Rc, tc, Xext):
        r = cameras.reprojection_residual(intr_c[gidx], Rc[ci], tc[ci], Xext[pe], uv) / f_ref
        return lm_mod.robust_cost(torch.sum(r * r, dim=-1), w_valid, huber_n)

    bmv = schur_mod._bmv
    bmtv = schur_mod._bmtv
    lam = torch.as_tensor(lam0, dtype=X.dtype, device=dev).reshape(())
    cost = halo_mod.all_reduce_sum(local_cost(intr, R, t, sh.gather_ext(X)), group)
    costs = [cost]
    for _ in range(iters):
        Xext = sh.gather_ext(X)                                        # AG
        r, Jc, Jp, Jk = lm_mod._jacobians_k(intr, k_idx, R, t, Xext, cam_l, pt_ext, uv,
                                             params, f_ref)
        w = w_valid * lm_mod.huber_weight(torch.sum(r * r, dim=-1), huber_n)
        ws = w[:, None, None]
        Jcw, Jkw = (Jc * ws).transpose(1, 2), (Jk * ws).transpose(1, 2)
        U = sh.reduce_cam(Jcw @ Jc)                                    # (Cb,6,6)
        b_c = sh.reduce_cam(-(Jcw @ r[..., None])[..., 0])
        Uck = sh.reduce_cam(Jcw @ Jk)                                  # (Cb,6,np)
        W_o = Jcw @ Jp                                                 # (Ob,6,3)
        Wk_o = Jkw @ Jp                                                # (Ob,np,3)
        V_o = ((Jp * ws).transpose(1, 2) @ Jp).reshape(-1, 9)
        bp_o = -((Jp * ws).transpose(1, 2) @ r[..., None])[..., 0]
        Vbp = sh.reduce_pt(torch.cat([V_o, bp_o], dim=-1))             # RS
        V9, b_p = Vbp[:, :9], Vbp[:, 9:]
        Ukk = reduce_group(Jkw @ Jk)                                   # all-reduce
        b_k = reduce_group(-(Jkw @ r[..., None])[..., 0])

        Ud = schur_mod._damp(U, lam)
        Ukk_d = schur_mod._damp(Ukk, lam)
        Vinv9 = schur_mod._damp_inv3_planes(V9, lam)
        Vinv_bp_ext = sh.gather_ext(schur_mod._mv3_planes(Vinv9, b_p))  # AG
        b_red_c = b_c - sh.reduce_cam(bmv(W_o, Vinv_bp_ext[pe]))
        b_red_k = b_k - reduce_group(bmv(Wk_o, Vinv_bp_ext[pe]))

        def matvec(x_c, x_k):
            y_c = bmv(Ud, x_c) + bmv(Uck, x_k[kl])
            y_k = bmv(Ukk_d, x_k) + reduce_cam_group(bmtv(Uck, x_c))
            Wtx = bmtv(W_o, x_c[ci]) + bmtv(Wk_o, x_k[gidx])
            Vy_ext = sh.gather_ext(schur_mod._mv3_planes(Vinv9, sh.reduce_pt(Wtx)))  # RS, AG
            y_c = y_c - sh.reduce_cam(bmv(W_o, Vy_ext[pe]))
            y_k = y_k - reduce_group(bmv(Wk_o, Vy_ext[pe]))
            return y_c, y_k

        # the camera part of every inner product is block-local (summed
        # over ranks); the intrinsics part is replicated
        dx_c, dx_k = schur_mod.pcg_pair(matvec, Ud, Ukk_d, b_red_c, b_red_k, cg_iters, fixed,
                                        dot_c=sh.dot)

        # back-substitute owned points
        Wtx = bmtv(W_o, dx_c[ci]) + bmtv(Wk_o, dx_k[gidx])
        dx_p = schur_mod._mv3_planes(Vinv9, b_p - sh.reduce_pt(Wtx))   # RS
        dxp_ext = sh.gather_ext(dx_p)                                  # AG

        alphas = lm_mod._ALPHAS
        cands = []
        for a in alphas:
            R2, t2 = se3.perturb_b(R, t, a * dx_c)
            cands.append((_delta_to_intr(intr, a * dx_k, params), R2, t2))
        trial = halo_mod.all_reduce_sum(torch.stack(
            [local_cost(k2, R2, t2, Xext + a * dxp_ext) for (k2, R2, t2), a in zip(cands, alphas)]),
            group)
        best, accept, new_cost, lam = lm_mod.lm_decide(trial, cost, lam)
        cost = torch.where(accept, new_cost, cost)
        pick = lambda i: torch.stack([c[i] for c in cands])[best][0]
        a_best = torch.tensor(alphas, dtype=X.dtype, device=dev)[best][0]
        intr = torch.where(accept, pick(0), intr)
        R = torch.where(accept, pick(1), R)
        t = torch.where(accept, pick(2), t)
        X = torch.where(accept, X + a_best * dx_p, X)
        costs.append(cost)
    return intr, R, t, X, torch.stack(costs), lam


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _blocks(rank: int, n_blocks: int, device, arrays):
    """This rank's block of each stacked (n*cap, ...) array (numpy or a
    tensor), on ``device``; integer ids as int64."""
    out = []
    for a in arrays:
        cap = a.shape[0] // n_blocks
        x = a[rank * cap:(rank + 1) * cap]
        x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.ascontiguousarray(x),
                            device=device)
        out.append(x if x.is_floating_point() or x.dtype == torch.bool else x.long())
    return out


def make_block_ba_step(*, n_blocks: int, hcap: int, device, iters: int = 10,
                       cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """The point-sharded BA solver of the process group on the stacked
    layout of ``dist.block_layout``: ``step(intr, lam0, k_idx, R, t, X,
    fixed, cam_l, pt_ext, uv, w, halo_idx, halo_mask)`` takes the stacked
    (n*cap, ...) arrays (numpy or tensors) on every rank, moves this rank's
    block to ``device``, and returns (R, t, X, costs, lam): the state in the
    stacked layout on every rank (one all-gather), the costs and the final
    damping, so a chunked caller resumes the trust region."""
    def step(intr, lam0, *stacked):
        rank = dist.get_rank(group)
        intr = torch.as_tensor(_np(intr), dtype=torch.float32, device=device)
        R_s, t_s, X_s, costs, lam = block_lm_local(
            intr, lam0, *_blocks(rank, n_blocks, device, stacked), n_blocks=n_blocks,
            hcap=hcap, iters=iters, cg_iters=cg_iters, huber_px=huber_px, group=group)
        cat = lambda x: halo_mod.all_gather_cat(x, group)
        return cat(R_s), cat(t_s), cat(X_s), costs, lam

    return step


def make_block_ba_step_k(*, n_blocks: int, hcap: int, device, params: tuple = ("f", "k1"),
                         iters: int = 10, cg_iters: int = 30, huber_px: float = 4.0,
                         group=None):
    """The point-sharded joint pose, point and intrinsics step, on the same
    stacked layout as ``make_block_ba_step``; returns (intr, R, t, X, costs,
    lam) with intr replicated."""
    def step(intr, lam0, *stacked):
        rank = dist.get_rank(group)
        intr = torch.as_tensor(_np(intr), dtype=torch.float32, device=device)
        intr_f, R_s, t_s, X_s, costs, lam = block_lm_local_k(
            intr, lam0, *_blocks(rank, n_blocks, device, stacked), params=params,
            n_blocks=n_blocks, hcap=hcap, iters=iters, cg_iters=cg_iters, huber_px=huber_px,
            group=group)
        cat = lambda x: halo_mod.all_gather_cat(x, group)
        return intr_f, cat(R_s), cat(t_s), cat(X_s), costs, lam

    return step


def _stacked(layout: BlockLayout, k_idx, R, t, X, fixed):
    """The global problem's camera and point arrays in the stacked layout,
    pad cameras held fixed (gauge-safe), and the observation and halo
    arrays: (k, R, t, X, fixed, cam_l, pt_ext, uv, w, halo_idx, halo_mask)."""
    k_l, R_l, t_l, fixed_l = scatter_cams(layout, _np(k_idx), _np(R), _np(t), _np(fixed))
    (X_l,) = scatter_pts(layout, _np(X))
    return (k_l, R_l, t_l, X_l, fixed_l | (layout.cam_global < 0), layout.obs_cam_l,
            layout.obs_pt_ext, layout.obs_uv, layout.obs_w, layout.halo_idx, layout.halo_mask)


def _global(layout: BlockLayout, n_cams: int, n_pts: int, device, R_s, t_s, X_s):
    R_g, t_g = gather_cams(layout, n_cams, _np(R_s), _np(t_s))
    (X_g,) = gather_pts(layout, n_pts, _np(X_s))
    return tuple(torch.as_tensor(a, device=device) for a in (R_g, t_g, X_g))


def _layout(layout, cam_id, pt_id, uv, w, n_cams, n_pts, group):
    if layout is not None:
        return layout
    return build_block_layout(_np(cam_id), _np(pt_id), _np(uv), _np(w), n_cams, n_pts,
                              dist.get_world_size(group))


def ba_solve_blocked(intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed_cam_mask, *,
                     device, layout: BlockLayout | None = None, iters: int = 10,
                     cg_iters: int = 30, huber_px: float = 4.0, ckpt_path=None,
                     ckpt_every: int = 10, group=None):
    """Global scene in, global scene out, on every rank of the group.

    Builds the block layout for the world (or reuses ``layout``), scatters
    the global arrays into the stacked layout, runs the sharded step (each
    rank on its block, on ``device``), and maps the result back to global
    camera and point order.

    ckpt_path: when given, the solve runs in ``ckpt_every``-iteration chunks,
    rank 0 writing an LM-state checkpoint (global R/t/X + damping + the
    iteration count, ``solvers.ba_ckpt``'s format) between chunks, and every
    rank resuming from an existing checkpoint.  The layout is built once.

    Returns (R, t, X, costs, stats): tensors on ``device``, costs as numpy
    with a chunked run's duplicate leading costs dropped, and the layout's
    stats (halo fraction, per-block load, per-rank state sizes).
    """
    n_cams, n_pts = int(R.shape[0]), int(X.shape[0])
    layout = _layout(layout, cam_id, pt_id, uv, w, n_cams, n_pts, group)
    lam, start = 1e-4, 0
    if ckpt_path is not None and Path(ckpt_path).exists():
        R, t, X, lam, start = ba_ckpt.load_ckpt(ckpt_path, "cpu")
    k_l, R_l, t_l, X_l, *static = _stacked(layout, k_idx, R, t, X, fixed_cam_mask)
    mk = lambda n: make_block_ba_step(n_blocks=layout.n_blocks, hcap=layout.hcap,
                                      device=device, iters=n, cg_iters=cg_iters,
                                      huber_px=huber_px, group=group)
    run = lambda step, R_s, t_s, X_s, lam: step(intr, lam, k_l, R_s, t_s, X_s, *static)
    if ckpt_path is None:
        R_s, t_s, X_s, costs, _ = run(mk(iters), R_l, t_l, X_l, lam)
        costs = costs.cpu().numpy()
    else:
        costs_all = []
        it = start
        R_s, t_s, X_s = R_l, t_l, X_l
        while it < iters:
            n = min(ckpt_every, iters - it)
            R_s, t_s, X_s, c, lam = run(mk(n), R_s, t_s, X_s, lam)
            lam = float(lam)
            c = c.cpu().numpy()
            # drop the duplicate leading cost0 on continuation chunks
            costs_all.extend(c.tolist() if not costs_all else c[1:].tolist())
            it += n
            if dist.get_rank(group) == 0:
                ba_ckpt.save_ckpt(ckpt_path, *_global(layout, n_cams, n_pts, "cpu", R_s, t_s, X_s),
                                  lam, it)
            dist.barrier(group)
        costs = np.asarray(costs_all, np.float32)
    return (*_global(layout, n_cams, n_pts, device, R_s, t_s, X_s), costs, layout.stats())


def ba_solve_blocked_intrinsics(intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed_cam_mask, *,
                                device, layout: BlockLayout | None = None,
                                params: tuple = ("f", "k1"), iters: int = 10,
                                cg_iters: int = 30, huber_px: float = 4.0, group=None):
    """Distributed self-calibration: global scene in, refined intrinsics out.

    Returns (R, t, X, intr, costs, stats) on every rank, as
    ``ba_solve_blocked`` (the block-sharded ``lm.ba_solve_intrinsics``)."""
    n_cams, n_pts = int(R.shape[0]), int(X.shape[0])
    layout = _layout(layout, cam_id, pt_id, uv, w, n_cams, n_pts, group)
    step = make_block_ba_step_k(n_blocks=layout.n_blocks, hcap=layout.hcap, device=device,
                                params=params, iters=iters, cg_iters=cg_iters,
                                huber_px=huber_px, group=group)
    intr_f, R_s, t_s, X_s, costs, _ = step(intr, 1e-4, *_stacked(layout, k_idx, R, t, X,
                                                                  fixed_cam_mask))
    return (*_global(layout, n_cams, n_pts, device, R_s, t_s, X_s), intr_f,
            costs.cpu().numpy(), layout.stats())
