"""Intrinsics refinement (self-calibration): the parameterization of the
refined intrinsics and the alternating Gauss-Newton step (port of
``sfmx.solvers.intrinsics``).

Holding geometry fixed, each intrinsics group solves an independent
<= 5x5 GN system assembled with one segment sum over its observations.
The joint pose, point and intrinsics LM that a build runs with
``ReconConfig.refine_intrinsics`` is ``lm.ba_solve_intrinsics``, which uses
``PARAM_SPEC`` and ``_delta_to_intr`` from here.  Plain torch: the
reference has no kernel here.  Jacobians come from ``torch.func.jacrev``
under ``torch.func.vmap`` (two output rows an observation, so reverse mode
costs what the reference's ``jax.jacfwd`` does; forward mode in torch 2.13
promotes a tangent to float64 at an add of a Python scalar and then fails
at a float32 matmul).
"""
from __future__ import annotations

import torch
from torch.func import jacrev, vmap

from ..core import cameras

# which components of the length-7 intrinsics vector are refined
# [fx, fy, cx, cy, k1, k2, k3]; fx == fy kept through a shared focal delta
PARAM_SPEC = {
    "f": (0, 1),      # shared focal
    "cx": (2,),
    "cy": (3,),
    "k1": (4,),
    "k2": (5,),
}


def _delta_to_intr(k: torch.Tensor, delta: torch.Tensor, params) -> torch.Tensor:
    """Apply a small parameter vector delta (..., len(params)) to
    intrinsics k (..., 7); leading dimensions broadcast."""
    cols = [k[..., j] for j in range(7)]
    for i, name in enumerate(params):
        for comp in PARAM_SPEC[name]:
            cols[comp] = cols[comp] + delta[..., i]
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def refine_intrinsics_gn(intr, k_idx, R, t, X, cam_id, pt_id, uv, w, *,
                         params: tuple = ("f", "k1"), iters: int = 3,
                         damping: float = 1e-3) -> torch.Tensor:
    """GN on the intrinsics table (I,7) with geometry held fixed; returns
    the refined table.  Residuals are focal-normalized like the BA's; each
    group's system is summed over its observations (obs -> group via
    k_idx[cam_id]); a step is kept only if the global cost falls."""
    I = intr.shape[0]
    n_p = len(params)
    ci, pi = cam_id.long(), pt_id.long()
    group = k_idx.long()[ci]                               # (O,)
    Ro, to, Xo = R[ci], t[ci], X[pi]

    def cost(it):
        rr = cameras.reprojection_residual(it[group], Ro, to, Xo, uv)
        return torch.sum(torch.sum(rr * rr, dim=-1) * w)

    for _ in range(iters):
        f_ref = torch.mean(0.5 * (intr[:, 0] + intr[:, 1]))

        def res(d, kc, Rc, tc, Xp, uv_o):
            return cameras.reprojection_residual(_delta_to_intr(kc, d, params), Rc, tc, Xp,
                                                 uv_o) / f_ref

        zero = torch.zeros(n_p, dtype=intr.dtype, device=intr.device)
        args = (intr[group], Ro, to, Xo, uv)
        r = res(zero, *args)                                              # (O,2)
        J = vmap(jacrev(res), in_dims=(None, 0, 0, 0, 0, 0))(zero, *args)  # (O,2,n_p)
        Jw = J * w[:, None, None]
        H = torch.zeros((I, n_p, n_p), dtype=intr.dtype, device=intr.device).index_add_(
            0, group, Jw.transpose(1, 2) @ J)
        g = torch.zeros((I, n_p), dtype=intr.dtype, device=intr.device).index_add_(
            0, group, (Jw.transpose(1, 2) @ r[..., None])[..., 0])
        # multiplicative damping: focal (pixels) and distortion (unitless)
        # differ by ~3 orders of magnitude, absolute damping cripples one
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        H = H + torch.diag_embed(damping * d + 1e-12)
        delta = -torch.linalg.solve(H, g[..., None])[..., 0]            # (I,n_p)
        intr2 = _delta_to_intr(intr, delta, params)
        intr = torch.where(cost(intr2) < cost(intr), intr2, intr)
    return intr
