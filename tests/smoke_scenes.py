"""Numpy-only scenes shared by the port's tests and ``chip_smoke.py``.

- the textured room of ``examples/room.py``: rendered frames, and a scene
  with one landmark per keyframe keypoint, placed where the keypoint's ray
  leaves the room box at the true pose;
- the synthetic map and query of ``bench.py``'s gather-path tripwire.
"""
from __future__ import annotations

import numpy as np


def render(tex, poses, width: int, height: int, focal: float) -> np.ndarray:
    """(N,H,W) float32 frames of the room at poses [(R, t, eye), ...]."""
    from examples import room

    return np.stack([room.render_room(tex, R, eye, width, height, focal)
                     for R, _t, eye in poses])


def raycast_room(R: np.ndarray, eye: np.ndarray, uv: np.ndarray, intr: np.ndarray,
                 box: np.ndarray) -> np.ndarray:
    """World points where the pixel rays uv (N,2) of a camera (R world->cam,
    center eye) leave the axis-aligned box (3,2) that contains the camera."""
    d_cam = np.concatenate([(uv - intr[2:4]) / intr[0:2], np.ones((len(uv), 1))], axis=1)
    d = d_cam @ R                                       # R^T d, (N,3)
    with np.errstate(divide="ignore"):
        t_side = np.where(d > 0, (box[:, 1] - eye) / d, (box[:, 0] - eye) / d)
    t_side = np.where(np.abs(d) < 1e-12, np.inf, t_side)
    t = t_side.min(axis=1)
    return (eye[None, :] + t[:, None] * d).astype(np.float32)


def room_scene(poses, uv: np.ndarray, mask: np.ndarray, intr: np.ndarray, box: np.ndarray):
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


def tripwire_case(seed: int = 42, P: int = 8192, C: int = 64, Kc: int = 128,
                  D: int = 128, K: int = 512):
    """bench.py's tripwire: a random map of P landmarks in front of an
    identity camera and K exact projections of landmarks of 4 keyframes.
    A correct gather path recovers R = I, t = 0 with >= K/2 inliers.
    Returns (map columns, q_desc (K,D), q_uv (K,2), intr (7,))."""
    Wt, Ht, f = 640, 480, 560.0
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3.0, 8.0, P)
    lm_desc = rng.standard_normal((P, D)).astype(np.float32)
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    kf_lm = rng.permutation(P)[: C * Kc].reshape(C, Kc).astype(np.int32)
    kf_g = lm_desc[kf_lm].mean(1)
    kf_g /= np.maximum(np.linalg.norm(kf_g, axis=1, keepdims=True), 1e-8)
    cols = dict(X=X, lm_desc=lm_desc, lm_alive=np.ones(P, bool), kf_gdesc=kf_g,
                kf_alive=np.ones(C, bool), kf_centers=np.zeros((C, 3), np.float32),
                kf_lm=kf_lm, kf_lm_mask=np.ones((C, Kc), bool))
    sel = kf_lm[:4].reshape(-1)[:K]
    q_uv = np.stack([f * X[sel, 0] / X[sel, 2] + Wt / 2,
                     f * X[sel, 1] / X[sel, 2] + Ht / 2], 1).astype(np.float32)
    intr = np.array([f, f, Wt / 2, Ht / 2, 0, 0, 0], np.float32)
    return cols, lm_desc[sel], q_uv, intr
