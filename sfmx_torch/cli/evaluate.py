"""Evaluation tooling (port of ``sfmx.cli.evaluate``): trajectory ATE,
per-frame errors and map statistics, computed on the scene's device."""
from __future__ import annotations

import json

import numpy as np
import torch

from ..mapstore.scene import Scene
from ..solvers import lm, umeyama


def evaluate_trajectory(est_centers, ref_centers, mask=None, with_scale: bool = True, *,
                        device) -> dict:
    """ATE (Umeyama-aligned RMSE) + per-frame error stats of (C,3) estimated
    centers against (C,3) reference ones; ``mask`` (C,) selects the frames.
    The alignment runs on ``device``."""
    est = np.asarray(est_centers.detach().cpu() if torch.is_tensor(est_centers)
                     else est_centers, np.float32)
    ref = np.asarray(ref_centers)
    mask = np.ones(len(est), bool) if mask is None else np.asarray(
        mask.detach().cpu() if torch.is_tensor(mask) else mask).astype(bool)
    e = torch.as_tensor(est, device=device)
    rmse, (s, R, t) = umeyama.ate_rmse(e, torch.as_tensor(ref, dtype=torch.float32,
                                                          device=device),
                                       torch.as_tensor(mask, device=device),
                                       with_scale=with_scale)
    aligned = umeyama.apply_sim3(s, R, t, e).cpu().numpy()
    err = np.linalg.norm(aligned - ref, axis=1)[mask]
    return {
        "ate_rmse": float(rmse),
        "ate_mean": float(err.mean()) if len(err) else float("nan"),
        "ate_median": float(np.median(err)) if len(err) else float("nan"),
        "ate_max": float(err.max()) if len(err) else float("nan"),
        "n_frames": int(mask.sum()),
        "scale": float(s),
    }


def scene_stats(scene: Scene) -> dict:
    """Counts, reprojection RMSE (px) and mean track length of a scene, on
    the scene's device."""
    n_cams, n_pts, n_obs = scene.counts()
    w = scene.obs_alive.to(torch.float32)
    rmse = lm.reprojection_rmse(scene.intr, scene.cam_k, scene.cam_R, scene.cam_t, scene.X,
                                scene.obs_cam, scene.obs_pt, scene.obs_uv, w)
    track_len = torch.bincount(scene.obs_pt.long()[scene.obs_alive],
                               minlength=scene.X.shape[0])
    alive = scene.X_alive
    return {
        "n_cameras": n_cams,
        "n_points": n_pts,
        "n_observations": n_obs,
        "reproj_rmse_px": float(rmse),
        "mean_track_length": (float(track_len[alive].to(torch.float64).mean())
                              if bool(alive.any()) else 0.0),
    }


def print_report(report: dict):
    print(json.dumps(report, indent=2))
