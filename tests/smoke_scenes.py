"""Numpy-only scenes shared by the port's tests and ``chip_smoke.py``.

- the textured room of ``examples/room.py``: rendered frames (serially or
  in worker processes), a walk across it and back (``loop_walk_poses``),
  the surface point behind each pixel (``raycast_room``), and a scene with
  one landmark per keyframe
  keypoint, placed where the keypoint's ray leaves the room box at the
  true pose;
- the same room with one landmark per surface point (``merged_room_scene``):
  observations whose ray hits fall in one ~1.5 cm cell share a landmark, so
  ``build_localization_map`` mean-pools their descriptors — what an SfM
  track does, and what the streaming path's Lowe ratio test needs (near-
  identical landmark duplicates would make it reject the true matches);
- distractor rooms (``combine_scenes``): scenes of rooms rendered with other
  textures, translated elsewhere in the world frame, joined into one map
  like the rooms of one building;
- the synthetic map and query of ``bench.py``'s gather-path tripwire.
"""
from __future__ import annotations

import numpy as np


def render(tex, poses, width: int, height: int, focal: float) -> np.ndarray:
    """(N,H,W) float32 frames of the room at poses [(R, t, eye), ...]."""
    from examples import room

    return np.stack([room.render_room(tex, R, eye, width, height, focal)
                     for R, _t, eye in poses])


def _render_one(args):
    from examples import room

    seed, R, eye, width, height, focal = args
    return room.render_room(room.RoomTexture(seed=seed), R, eye, width, height, focal)


def render_parallel(seed: int, poses, width: int, height: int, focal: float,
                    workers: int) -> np.ndarray:
    """``render`` of ``RoomTexture(seed)`` in ``workers`` spawned processes
    (numpy only; the pool is shut down before returning)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    tasks = [(seed, R, eye, width, height, focal) for R, _t, eye in poses]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return np.stack(list(ex.map(_render_one, tasks)))


def loop_walk_poses(n: int, offset=(0.0, -0.1, 0.3), turn_deg: float = 5.0):
    """A walk across the room and back: the first n//2 poses of
    ``room.walk_poses``, then the same stretch in reverse order, ``offset``
    metres away and turned by ``turn_deg``, so the second pass revisits the
    places of the first (loop closures for retrieval to find)."""
    from examples import room

    half = n // 2
    poses = room.walk_poses(half)
    for R0, _t, eye in room.walk_poses(n - half, heading_deg=25.0 + turn_deg)[::-1]:
        e = eye + np.asarray(offset)
        R, t = room.look_at(e, e + 5.0 * R0[2])        # R0[2]: the viewing direction
        poses.append((R, t, e))
    return poses


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


def merged_room_scene(poses, uv: np.ndarray, mask: np.ndarray, intr: np.ndarray,
                      box: np.ndarray, cell: float = 0.015):
    """Scene columns with one landmark per surface cell: each valid keyframe
    keypoint's ray hit on the room box is quantized to a ``cell``-metre grid,
    observations in one cell share its landmark, placed at the mean of
    their hits.  Returns (scene columns, obs_feat)."""
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
    world frame: part i is translated by its offset (landmarks and camera
    centers), its cameras and landmarks renumbered after the earlier
    parts'.  Keyframe features are concatenated by the caller in the same
    order.  Returns (scene columns, obs_feat)."""
    out = {k: [] for k in ("obs_cam", "obs_pt", "obs_alive", "X", "X_alive",
                           "cam_R", "cam_t", "cam_alive")}
    feats, n_cam, n_pt = [], 0, 0
    for scene, obs_feat, offset in parts:
        off = np.asarray(offset, np.float32)
        out["obs_cam"].append(scene["obs_cam"] + n_cam)
        out["obs_pt"].append(scene["obs_pt"] + n_pt)
        out["X"].append(scene["X"] + off)
        # center c' = c + off  =>  t' = -R c' = t - R off
        out["cam_t"].append(scene["cam_t"] - scene["cam_R"] @ off)
        for k in ("obs_alive", "X_alive", "cam_R", "cam_alive"):
            out[k].append(scene[k])
        feats.append(obs_feat)
        n_cam += len(scene["cam_R"])
        n_pt += len(scene["X"])
    cols = {k: np.concatenate(v).astype(v[0].dtype) for k, v in out.items()}
    return cols, np.concatenate(feats)


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


def pair_near_ties(descs, masks, pairs, ratio: float, tol: float = 1e-5):
    """Rows of a pair-matching result whose outcome a summation-order
    difference of up to ``tol`` in the scores can flip, by the plain
    (dense) semantics: the row's best two columns within tol, the best two
    rows of its winning column within tol, or the ratio test within 4 tol
    of its boundary (d = 2 - 2 s doubles an error).  A masked row's outcome
    is fixed (score NEG, index 0, not valid), so it is never a near-tie.
    torch, on the inputs' device, chunked over pairs.  Returns an (Np,K)
    bool tensor."""
    import torch

    pairs = torch.as_tensor(np.asarray(pairs), device=descs.device).to(torch.int64)
    K = descs.shape[1]
    step = max(1, (1 << 26) // (K * K))
    out = []
    for s in range(0, len(pairs), step):
        a, b = pairs[s:s + step, 0], pairs[s:s + step, 1]
        da = descs[a].to(torch.bfloat16).to(torch.float32)
        db = descs[b].to(torch.bfloat16).to(torch.float32)
        sim = da @ db.transpose(-1, -2)
        both = masks[a][:, :, None] & masks[b][:, None, :]
        sim = torch.where(both, sim, torch.full_like(sim, -1e30))
        v, i = torch.topk(sim, 2, dim=-1)
        cv = torch.topk(sim, 2, dim=-2).values                      # (n,2,K)
        col_gap = torch.gather(cv[:, 0] - cv[:, 1], 1, i[..., 0])
        d1 = torch.clamp(2.0 - 2.0 * v[..., 0], min=0.0)
        d2 = torch.clamp(2.0 - 2.0 * v[..., 1], min=1e-12)
        out.append(((v[..., 0] - v[..., 1] < tol) | (col_gap < tol)
                    | ((d1 - ratio * ratio * d2).abs() < 4 * tol)) & masks[a])
    return torch.cat(out) if out else torch.zeros((0, K), dtype=torch.bool)


def ba_problem(C: int, P: int, O: int, seed: int = 0, *, window: int = 6,
               noise_px: float = 0.3, perturb: float = 0.0, long_tracks: int = 0) -> dict:
    """A random bundle-adjustment problem with camera-local visibility (what
    incremental SfM produces): cameras near the origin with small random
    rotations look down +z at points 25 units away; point p is seen by
    cameras of a sliding window of ``window`` ids.  The last 3 points and the
    last camera get no observation; ``long_tracks`` points are seen by up to
    4*window cameras (tracks longer than a small slot count).  ``perturb``
    moves t and X off the truth (the state a solve starts from).  Returns
    numpy arrays under the argument names of ``ba_solve``; the table is
    sorted by point."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-2, 2, (C, 2)), np.full((C, 1), 25.0)], 1).astype(np.float32)
    w = 0.05 * rng.standard_normal((C, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / th
    Kx = np.zeros((C, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 0] = -k[:, 2], k[:, 1], k[:, 2]
    Kx[:, 1, 2], Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 0], -k[:, 1], k[:, 0]
    R = (np.eye(3) + np.sin(th)[..., None] * Kx
         + (1 - np.cos(th))[..., None] * (Kx @ Kx)).astype(np.float32)
    pt_id = rng.integers(0, max(P - 3, 1), O)
    width = np.full(O, window)
    if long_tracks:
        longs = rng.choice(max(P - 3, 1), long_tracks, replace=False)
        extra = np.repeat(longs, 4 * window)
        pt_id = np.concatenate([pt_id, extra])
        width = np.concatenate([width, np.full(len(extra), 4 * window)])
    span = np.maximum(C - 1 - width, 1)
    cam_id = (pt_id / P * span).astype(np.int64) + rng.integers(0, width)
    cam_id = np.minimum(cam_id, C - 2)
    order = np.argsort(pt_id, kind="stable")
    pt_id, cam_id = pt_id[order].astype(np.int32), cam_id[order].astype(np.int32)
    intr = np.array([[500.0, 500.0, 320.0, 240.0, 0.0, 0.01, 0.0]], np.float32)
    Xc = np.einsum("oij,oj->oi", R[cam_id], X[pt_id]) + t[cam_id]
    xn = Xc[:, :2] / Xc[:, 2:3]
    r2 = np.sum(xn * xn, axis=1, keepdims=True)
    uv = (xn * (1.0 + 0.01 * r2 * r2) * 500.0 + np.array([320.0, 240.0])
          + noise_px * rng.standard_normal((len(pt_id), 2))).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    if perturb:
        t = (t + perturb * rng.standard_normal((C, 3))).astype(np.float32)
        X = (X + perturb * rng.standard_normal((P, 3))).astype(np.float32)
    return dict(intr=intr, k_idx=np.zeros(C, np.int32), R=R, t=t, X=X, cam_id=cam_id,
                pt_id=pt_id, uv=uv, w_valid=np.ones(len(pt_id), np.float32),
                fixed_cam_mask=fixed)
