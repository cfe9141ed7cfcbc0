"""Checkpointed bundle adjustment (port of ``sfmx.solvers.ba_ckpt``).

LM state checkpoints every k iterations, so that a lost process resumes
from the last checkpoint instead of restarting the solve.  State = (R, t,
X, lam, iter) in the reference's versioned npz: a checkpoint written by
either package loads in the other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

CKPT_VERSION = 1


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ckpt(path: str | Path, R, t, X, lam: float, it: int):
    # temp name must end in .npz or np.savez appends the extension itself
    tmp = Path(str(path) + ".tmp.npz")
    np.savez(tmp, version=CKPT_VERSION, R=_np(R), t=_np(t), X=_np(X),
             lam=np.float32(lam), it=np.int64(it))
    tmp.replace(path)  # atomic on POSIX


def load_ckpt(path: str | Path, device):
    """(R, t, X) tensors on ``device``, lam, iteration."""
    with np.load(path) as z:
        if int(z["version"]) > CKPT_VERSION:
            raise ValueError("checkpoint from a newer format")
        return (*(torch.as_tensor(z[k], device=device) for k in ("R", "t", "X")),
                float(z["lam"]), int(z["it"]))


def ba_solve_checkpointed(
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed_cam_mask, *,
    total_iters: int = 40, ckpt_every: int = 10, ckpt_path: str | Path,
    cg_iters: int = 30, huber_px: float = 4.0, ba_fn=None, **ba_kwargs,
):
    """Run BA in ckpt_every-sized chunks, checkpointing between chunks.

    Resumes automatically if ckpt_path exists; the LM damping is threaded
    through every chunk and through resume, so a resumed solve continues
    where the lost one left off.  ``ba_kwargs`` pass through to
    ``lm.ba_solve`` (the dense path's ``tp_cap``, ``dense_cg``, ``ov_cap``:
    every chunk then runs K6-K8).

    ba_fn defaults to lm.ba_solve; a custom ba_fn must accept
    ``(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed_cam_mask,
    iters=n, init_lambda=lam)`` and return ``(R, t, X, costs, lam)``.
    Returns (R, t, X, costs of every chunk (numpy), iterations run here).
    """
    from . import lm

    ckpt_path = Path(ckpt_path)
    start = 0
    lam = 1e-4
    if ckpt_path.exists():
        R, t, X, lam, start = load_ckpt(ckpt_path, X.device)

    costs_all = []
    it = start
    while it < total_iters:
        n = min(ckpt_every, total_iters - it)
        if ba_fn is None:
            R, t, X, costs, lam = lm.ba_solve(
                intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid, fixed_cam_mask,
                iters=n, cg_iters=cg_iters, huber_px=huber_px, init_lambda=lam,
                return_lam=True, **ba_kwargs)
        else:
            R, t, X, costs, lam = ba_fn(intr, k_idx, R, t, X, cam_id, pt_id, uv, w_valid,
                                        fixed_cam_mask, iters=n, init_lambda=lam)
        lam = float(lam)
        costs_all.extend(_np(costs).tolist())
        it += n
        save_ckpt(ckpt_path, R, t, X, lam, it)
    return R, t, X, np.asarray(costs_all), it - start
