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
- the reference's stalling two-cluster scene at a build's size
  (``two_cluster_world``), for secondary components;
- the rotated blob-texture pair of tests/test_features.py
  (``blob_texture``, ``warp_affine``) and a PIL-like bilinear downscale
  (``resize_bilinear``), for the extractors' gates where PIL is missing.
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


def two_cluster_world(n_per_arc: int = 48, n_cluster: int = 3000, n_shared: int = 40,
                      K: int = 1024, seed: int = 0, noise: float = 0.03):
    """The reference's stalling scene (``tests/test_multicomponent.py``'s
    ``_two_cluster_world`` and ``_features``) at a build's size: two point
    clouds of ``n_cluster`` points 8 units apart, each seen by an arc of
    ``n_per_arc`` cameras (640x480, f=400, +-35 deg), joined only by a
    boundary cloud of ``n_shared`` points that both arcs see.  Each camera
    keeps K of its visible points as keypoints at their exact pixel
    positions, as the reference's do, with 128-float descriptors (a random
    unit vector per point plus ``noise``, renormalized).

    The boundary cloud is big enough for a verified similarity between two
    components (>= 8 shared tracks) and too small for a camera of one arc
    to resect against the other arc's map (< 25 keypoints on it).  Returns
    (uv (C,K,2), desc (C,K,128), mask (C,K), intr (7,), centers (C,3),
    feat_pt (C,K) point id or -1)."""
    from examples import room

    rng = np.random.default_rng(seed)
    A = rng.uniform(-2.0, 2.0, (n_cluster, 3))
    B = rng.uniform(-2.0, 2.0, (n_cluster, 3)) + np.array([8.0, 0.0, 0.0])
    S = rng.uniform(-1.2, 1.2, (n_shared, 3)) + np.array([4.0, 0.0, 0.0])
    pts = np.concatenate([A, S, B])
    nA, nS = len(A), len(S)
    width, height, f = 640, 480, 400.0
    intr = np.array([f, f, width / 2.0, height / 2.0, 0, 0, 0], np.float32)
    Rs, ts, allowed = [], [], []
    angles = np.deg2rad(np.linspace(-35.0, 35.0, n_per_arc))
    for center, ids in ((np.zeros(3), np.arange(nA + nS)),
                        (np.array([8.0, 0.0, 0.0]), np.arange(nA, len(pts)))):
        for a in angles:
            R, t = room.look_at(center + 6.0 * np.array(
                [np.sin(a), 0.4 * np.sin(2 * a) + 0.15, -np.cos(a)]), center)
            Rs.append(R)
            ts.append(t)
            allowed.append(ids)
    Rs, ts = np.stack(Rs), np.stack(ts)
    C = len(Rs)
    cam = np.einsum("cij,pj->cpi", Rs, pts) + ts[:, None, :]
    z = cam[..., 2]
    px = cam[..., :2] / np.maximum(z[..., None], 1e-9) * f + np.array([width, height]) / 2.0
    in_frustum = ((z > 0.5) & (z < 12.0) & (px[..., 0] >= 0) & (px[..., 0] < width)
                  & (px[..., 1] >= 0) & (px[..., 1] < height))
    base = rng.normal(size=(len(pts), 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    uv = np.zeros((C, K, 2), np.float32)
    desc = np.zeros((C, K, 128), np.float32)
    mask = np.zeros((C, K), bool)
    feat_pt = np.full((C, K), -1, np.int64)
    for c in range(C):
        ids = allowed[c][in_frustum[c, allowed[c]]]
        ids = ids[rng.permutation(len(ids))[:K]]
        n = len(ids)
        uv[c, :n] = px[c, ids]
        d = base[ids] + noise * rng.normal(size=(n, 128)).astype(np.float32)
        desc[c, :n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[c, :n] = True
        feat_pt[c, :n] = ids
    centers = np.einsum("cji,cj->ci", Rs, -ts)
    return uv, desc, mask, intr, centers, feat_pt


def blob_texture(rng, h: int = 160, w: int = 160) -> np.ndarray:
    """Smooth random texture with strong corners (a sum of 40 Gaussian
    blobs) in [0,1]: tests/test_features.py's ``make_texture``."""
    img = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(40):
        cy, cx = rng.uniform(20, h - 20), rng.uniform(20, w - 20)
        s = rng.uniform(2.0, 6.0)
        a = rng.uniform(0.3, 1.0) * rng.choice([-1, 1])
        img += a * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    img -= img.min()
    img /= img.max()
    return img


def warp_affine(img: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Inverse warp by the 2x3 affine M with bilinear sampling."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w, np.float32)])
    src = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2] @ pts
    sx = np.clip(src[0], 0, w - 1.001)
    sy = np.clip(src[1], 0, h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = sx - x0, sy - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return out.reshape(h, w).astype(np.float32)


def rotated_pair(seed: int = 5, deg: float = 25.0):
    """tests/test_features.py's pair: a 160x160 blob texture and its copy
    rotated by ``deg`` about the center and shifted by (6, -4) px.
    Returns ((2,H,W) float32, the 2x3 affine)."""
    img = blob_texture(np.random.default_rng(seed))
    h, w = img.shape
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    cx, cy = w / 2, h / 2
    M = np.array([[c, -s, cx - c * cx + s * cy + 6.0], [s, c, cy - s * cx - c * cy - 4.0]])
    return np.stack([img, warp_affine(img, M)]).astype(np.float32), M


def _resample_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) triangle-filter weights widened by the scale factor,
    as PIL's BILINEAR resample builds them."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    wm = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo, hi = max(int(center - support + 0.5), 0), min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi)
        wt = np.clip(1.0 - np.abs((x - center + 0.5) / support), 0.0, None)
        wm[i, lo:hi] = wt / wt.sum()
    return wm


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """A [0,1] gray image resized to size=(w,h) like
    ``PIL.Image.fromarray(uint8).resize(size, BILINEAR)``: quantized to
    uint8, filtered horizontally then vertically, each pass rounded to
    uint8; returns float32 in [0,1]."""
    h_in, w_in = img.shape
    u8 = (img * 255).astype(np.uint8).astype(np.float64)
    rnd = lambda a: np.clip(np.floor(a + 0.5), 0, 255)
    out = rnd(u8 @ _resample_weights(w_in, size[0]).T)
    out = rnd(_resample_weights(h_in, size[1]) @ out)
    return out.astype(np.float32) / 255.0
