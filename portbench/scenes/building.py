"""The serving cells' building: a frozen, extended copy of ``chip_smoke.py``'s
``phase_map_scale`` (commit 9fe1547).

The query room's keyframes merged to one landmark per surface cell, then
distractor rooms (other textures, one landmark per keyframe keypoint, 20 m
apart along x), then "floors": copies of the distractor rooms one storey up
each (their keyframes copied with them), whose keyframe descriptors carry
seeded noise at the level the query room's own tracks show between views,
renormalized, until the map holds exactly ``landmarks`` landmarks (the last
copy is cut short).  The pool of query images is rendered at held-out
poses of the query room.  Frames are rendered on the device
(``room.render_room_torch``), every descriptor comes from the benchmark's own
plain extraction (``portbench.ref.extract``), the floors' noise from a
generator on the device seeded from the run's seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import seeding
from . import helpers, room


def _seeds(seed: int, n: int) -> list[int]:
    return [int(s) for s in seeding.seq(seed, 7).generate_state(n)]


def track_noise(scene, obs_feat, feat_desc, dims: int) -> float:
    """Per-dimension RMS deviation of an observation's descriptor from its
    landmark's mean, over the landmarks seen more than once."""
    pt = scene["obs_pt"]
    d = feat_desc[scene["obs_cam"], obs_feat][:, :dims].astype(np.float64)
    P = int(pt.max()) + 1
    cnt = np.bincount(pt, minlength=P)
    mean = np.zeros((P, dims))
    np.add.at(mean, pt, d)
    mean /= np.maximum(cnt, 1)[:, None]
    multi = cnt[pt] > 1
    dev = d[multi] - mean[pt[multi]]
    return float(np.sqrt(np.mean(dev * dev)))


def building(cfg: dict, seed: int, device, *, extract_batch: int = 32) -> dict:
    """Render, extract and assemble the building map and the query pool."""
    from ..ref import extract as rx

    img, mp = cfg["image"], cfg["map"]
    W, H, f = img["width"], img["height"], img["focal"]
    intr = np.array([f, f, W / 2, H / 2, 0.0, 0.0, 0.0], np.float32)
    n_rooms = mp["distractor_rooms"]
    tex = _seeds(seed, 1 + n_rooms)
    kf_poses = room.walk_poses(mp["keyframes"])
    pool_poses = room.walk_poses(2 * cfg["pool"] + 1)[1::2]
    t0 = time.perf_counter()
    jobs = [(tex[0], kf_poses), (tex[0], pool_poses)] + [(tex[i], kf_poses)
                                                         for i in range(1, 1 + n_rooms)]
    frames = [room.render_room_torch(room.RoomTexture(seed=ts), [R for R, _t, _e in poses],
                                     [e for _R, _t, e in poses], W, H, f, device)
              for ts, poses in jobs]
    t_render = time.perf_counter() - t0
    kw = dict(max_keypoints=cfg["features"]["max_keypoints"], threshold=cfg["features"]["threshold"],
              n_octaves=cfg["features"]["n_octaves"])
    feats = [rx.extract_batched(fr, device, batch=extract_batch, **kw) for fr in frames]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_extract = time.perf_counter() - t0 - t_render

    q, pool = feats[0], feats[1]
    scene, obs_feat = helpers.merged_room_scene(kf_poses, q["uv"], q["mask"], intr, room.ROOM,
                                                cell=mp["merge_cell_m"])
    sigma = track_noise(scene, obs_feat, q["desc"], rx.N_CELLS_RAW)
    parts, descs, masks = [(scene, obs_feat, np.zeros(3))], [q["desc"]], [q["mask"]]
    P = len(scene["X"])
    rooms = []
    for i in range(1, 1 + n_rooms):
        fi = feats[1 + i]
        sc, of = helpers.room_scene(kf_poses, fi["uv"], fi["mask"], intr, room.ROOM)
        rooms.append((sc, of, fi))
    noise_seed = int(seeding.seq(seed, 11).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    k, target = 0, mp["landmarks"]
    while P < target:
        j, storey = k % n_rooms, k // n_rooms
        sc, of, fi = rooms[j]
        desc = fi["desc"]
        if storey:
            d = torch.from_numpy(desc).to(device)
            noise = torch.randn(d[..., :rx.N_CELLS_RAW].shape, generator=gen, device=device)
            d[..., :rx.N_CELLS_RAW] += sigma * noise
            d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
            d[~torch.from_numpy(fi["mask"]).to(device)] = 0.0
            desc = d.cpu().numpy()
        n = min(len(sc["X"]), target - P)
        if n < len(sc["X"]):
            keep = sc["obs_pt"] < n
            sc = dict(sc, obs_cam=sc["obs_cam"][keep], obs_pt=sc["obs_pt"][keep],
                      obs_alive=sc["obs_alive"][keep], X=sc["X"][:n], X_alive=sc["X_alive"][:n])
            of = of[keep]
        off = np.array([mp["room_spacing_m"] * (j + 1), mp["storey_m"] * storey, 0.0])
        parts.append((sc, of, off))
        descs.append(desc)
        masks.append(fi["mask"])
        P += n
        k += 1
    cols, obs = helpers.combine_scenes(parts)
    assert len(cols["X"]) == target, (len(cols["X"]), target)
    return {
        "intr": intr, "cols": cols, "obs_feat": obs, "feat_desc": np.concatenate(descs),
        "kp_mask": np.concatenate(masks), "pool_frames": frames[1], "pool": pool,
        "seconds": {"render": t_render, "extract": t_extract,
                    "assemble": time.perf_counter() - t0 - t_render - t_extract},
    }
