"""Scene helpers, frozen: copies of ``raycast_room``, ``room_scene``,
``merged_room_scene`` and ``combine_scenes`` from ``tests/smoke_scenes.py``
at commit 9fe1547.  Numpy only."""
from __future__ import annotations

import numpy as np


def raycast_room(R, eye, uv, intr, box):
    """World points where the pixel rays uv (N,2) of a camera (R world->cam,
    center eye) leave the axis-aligned box (3,2) that contains the camera."""
    d_cam = np.concatenate([(uv - intr[2:4]) / intr[0:2], np.ones((len(uv), 1))], axis=1)
    d = d_cam @ R
    with np.errstate(divide="ignore"):
        t_side = np.where(d > 0, (box[:, 1] - eye) / d, (box[:, 0] - eye) / d)
    t_side = np.where(np.abs(d) < 1e-12, np.inf, t_side)
    t = t_side.min(axis=1)
    return (eye[None, :] + t[:, None] * d).astype(np.float32)


def room_scene(poses, uv, mask, intr, box):
    """Scene columns with one landmark per valid keyframe keypoint, placed at
    its ray's hit on the room box.  Returns (scene columns, obs_feat)."""
    C = len(poses)
    cams, feats, Xs = [], [], []
    for c, (R, _t, eye) in enumerate(poses):
        k = np.flatnonzero(mask[c])
        cams.append(np.full(len(k), c, np.int32))
        feats.append(k.astype(np.int32))
        Xs.append(raycast_room(R, eye, uv[c, k].astype(np.float64), intr, box))
    obs_cam, obs_feat, X = np.concatenate(cams), np.concatenate(feats), np.concatenate(Xs)
    P = len(X)
    scene = {
        "obs_cam": obs_cam, "obs_pt": np.arange(P, dtype=np.int32),
        "obs_alive": np.ones(P, bool), "X": X, "X_alive": np.ones(P, bool),
        "cam_R": np.stack([R for R, _, _ in poses]).astype(np.float32),
        "cam_t": np.stack([t for _, t, _ in poses]).astype(np.float32),
        "cam_alive": np.ones(C, bool),
    }
    return scene, obs_feat


def merged_room_scene(poses, uv, mask, intr, box, cell: float = 0.015):
    """``room_scene`` with observations whose ray hits fall in one ``cell``-
    metre grid cell sharing one landmark at the mean of their hits."""
    scene, obs_feat = room_scene(poses, uv, mask, intr, box)
    X = scene["X"].astype(np.float64)
    _, obs_pt = np.unique(np.floor(X / cell).astype(np.int64), axis=0, return_inverse=True)
    obs_pt = obs_pt.reshape(-1)
    P = int(obs_pt.max()) + 1
    Xm = np.zeros((P, 3))
    np.add.at(Xm, obs_pt, X)
    Xm /= np.bincount(obs_pt, minlength=P)[:, None]
    scene.update(obs_pt=obs_pt.astype(np.int32), X=Xm.astype(np.float32),
                 X_alive=np.ones(P, bool))
    return scene, obs_feat


def combine_scenes(parts):
    """Join scenes [(scene columns, obs_feat, offset (3,)), ...] into one
    world frame, part i translated by its offset and renumbered after the
    earlier parts.  Returns (scene columns, obs_feat)."""
    out = {k: [] for k in ("obs_cam", "obs_pt", "obs_alive", "X", "X_alive",
                           "cam_R", "cam_t", "cam_alive")}
    feats, n_cam, n_pt = [], 0, 0
    for scene, obs_feat, offset in parts:
        off = np.asarray(offset, np.float32)
        out["obs_cam"].append(scene["obs_cam"] + n_cam)
        out["obs_pt"].append(scene["obs_pt"] + n_pt)
        out["X"].append(scene["X"] + off)
        out["cam_t"].append(scene["cam_t"] - scene["cam_R"] @ off)
        for k in ("obs_alive", "X_alive", "cam_R", "cam_alive"):
            out[k].append(scene[k])
        feats.append(obs_feat)
        n_cam += len(scene["cam_R"])
        n_pt += len(scene["X"])
    cols = {k: np.concatenate(v).astype(v[0].dtype) for k, v in out.items()}
    return cols, np.concatenate(feats)
