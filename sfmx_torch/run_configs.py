"""The repository's evaluation configurations on the port (port of
``bench/run_configs.py``: BASELINE.md configs 1-5).

    python -m sfmx_torch.run_configs --config N [--frames F] [--scene room|corridor]
        [--seed S] [--final-ba-iters I] [--rooms R] [--device cuda|cpu]
        [--world-size W]

  1       the demo (``sfmx_torch.demo``): 12 rendered room frames built and
          localized, its PASS gate
  2       a 32-frame rendered walkthrough through ``build_map``, then every
          frame localized against the map (``--frames`` > 32: ``2+``)
  2+      the streaming CLI build (``build-map --stream``, retrieval pairs)
          of a longer walk, its ATE gate and retrieval recall@8
  3       global BA at 512 cameras / 20,000 points / 200,000 observations
          (``lm.ba_solve``, the planes path on the segment-sum kernel)
  4       the point-sharded block BA (``dist.block_ba``) of a 2,048-camera
          synthetic corridor, one rank a card (``--frames`` >= 256:
          ``4-build``, a reconstructed corridor built by ``2+`` and solved
          by ``block_ba_real_scene``)
  5       three synthetic sessions reconstructed and merged (``--frames``
          >= 48: ``5-serve``, three rendered sessions built, merged,
          stored, reloaded and served over 4 map shards)

One function per function of the reference, under its name, with its
scene, draws, sizes and thresholds; each takes its settings as keywords
and an explicit ``device`` (the card unless the caller asks for the CPU),
and nothing parses arguments until ``main``.  A config prints one JSON
line: the reference's keys, values unrounded, plus ``device`` (the card's
name and power limit).  The kernel launches of the run go to standard
error as one more JSON line.  Nothing is caught: a failure raises.

As the reference, ``2+`` and ``4-build`` write the walk's frames as PNG
files through PIL for the command line to decode, and ``5-serve`` POSTs
its queries as PNGs to the HTTP app through aiohttp's test client;
without either package they raise, naming it.
"""
from __future__ import annotations

import argparse
import asyncio
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .bench import _sync, device_info
from .kernels import _build

# config 4's corridor problem and solver settings (bench/run_configs.py:config4)
CONFIG4 = dict(C=2048, P=200_000, obs_per_cam=800_000 // 2048, iters=8, cg_iters=25)
RENDER = dict(width=320, height=240, focal=280.0)   # every rendered config's camera


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _launches_since(before: dict) -> dict:
    """This process's kernel launches since the ``before`` snapshot."""
    out = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.counts.items()}
    return {k: v for k, v in out.items() if v}


def _repo_on_path() -> None:
    """The repository root on ``sys.path``: the rendered scenes are
    ``examples.room``'s and config 5's world ``tests.synthetic``'s (both
    numpy only)."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)


def _examples():
    _repo_on_path()
    from examples import room

    return room


def _intr() -> np.ndarray:
    f, w, h = RENDER["focal"], RENDER["width"], RENDER["height"]
    return np.array([[f, f, w / 2, h / 2, 0, 0, 0]], np.float32)


def _render_room(tex, poses) -> np.ndarray:
    room = _examples()
    return np.stack([room.render_room(tex, R, eye, RENDER["width"], RENDER["height"],
                                      RENDER["focal"]) for (R, _t, eye) in poses])


def default_world_size(device) -> int:
    """The reference solves on every device it sees: the visible cards, or
    one rank on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


# ---- frame files ------------------------------------------------------------


def quantize(img: np.ndarray) -> np.ndarray:
    """The 8 bits a PNG keeps of a [0,1] frame (8-bit frames as they are)."""
    return img if img.dtype == np.uint8 else (img * 255).astype(np.uint8)


def write_png_frames(directory: Path, frames) -> list[Path]:
    """Frames as 8-bit gray PNGs ``<i>.png`` (as the reference writes them)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PNG frame files need the PIL package (Pillow)") from e
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = directory / f"{i:05d}.png"
        Image.fromarray(quantize(f)).save(p)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Config 1
# ---------------------------------------------------------------------------


def config1(device):
    """The demo on ``device`` (``sfmx_torch.demo.main``): its PASS gate."""
    from .demo import main as demo_main

    t0 = time.time()
    rc = demo_main(["--device", str(device)])
    return {"config": 1, "pass": rc == 0, "wall_s": time.time() - t0}


# ---------------------------------------------------------------------------
# Config 2 and 2+
# ---------------------------------------------------------------------------


def window_for(frames: int, scene: str, rooms: int) -> int:
    """The reference's temporal match window.  The walk covers a fixed path,
    so a frame's baseline shrinks ~1/frames and the window must widen with
    it (room: frames // 8); a corridor walk keeps its window ~2.5 m of path
    (~7.75 m of path a room)."""
    if scene == "room":
        return max(6, frames // 8)
    return max(12, int(frames * 2.5 / (7.75 * rooms)))


def scale_argv(frames: int, root: Path, device, *, scene: str = "room", seed: int = 0,
               final_ba_iters: int = 0, rooms: int = 4) -> list[str]:
    """``config2_scale``'s ``build-map --stream`` command line: the
    reference's overrides, plus the device."""
    return [
        "build-map", str(root / "imgs"), "-o", str(root / "map"),
        "--stream", "--chunk", "16", "--workdir", str(root / "work"),
        "-D", "match.pair_mode=retrieval", "-D", "match.retrieval_k=6",
        "-D", f"match.window={window_for(frames, scene, rooms)}",
        "-D", "features.max_keypoints=512",
        "-D", "resize_to=320,240", "-D", "focal_factor=0.875",
        "-D", f"recon.seed={seed}",
        # long loop-free walks accumulate drift only the final BA corrects
        "-D", f"recon.final_ba_iters={final_ba_iters or (50 if frames >= 512 else 25)}",
        "--device", str(device),
    ]


def walk(frames: int, scene: str = "room", rooms: int = 4):
    """The rendered walk of ``config2_scale``: (poses, render(R, eye))."""
    room = _examples()
    w, h, f = RENDER["width"], RENDER["height"], RENDER["focal"]
    if scene == "corridor":
        cor = room.Corridor(n_rooms=rooms, seed=7)
        return (room.corridor_walk_poses(cor, frames),
                lambda R, eye: room.render_corridor(cor, R, eye, w, h, f))
    tex = room.RoomTexture(seed=7)
    return room.walk_poses(frames), lambda R, eye: room.render_room(tex, R, eye, w, h, f)


def config2_scale(device, root, *, frames: int, scene: str = "room", seed: int = 0,
                  final_ba_iters: int = 0, rooms: int = 4):
    """Config 2+: a rendered walk of ``frames`` through the command line's
    streaming build (threaded decode beside extraction on the card,
    retrieval pairs, verification, the stage cache), its ATE held to 1.5 %
    of the path (at least 0.1 m), the per-stage walls, and retrieval
    recall@8 of 16 held-out views on the built map.  The frames (PNGs, as
    the reference writes them), the map and the work directory go under
    ``root``, which the caller owns and removes."""
    from .cli import main as climain
    from .cli.config import FeatureConfig, PipelineConfig
    from .cli.pipeline import extract_features
    from .localize import retrieve
    from .mapstore.lmap_store import load_localization_map
    from .mapstore.scene import load_scene
    from .solvers import umeyama
    from .utils.logging import LOGGER

    device = torch.device(device)
    poses, render = walk(frames, scene, rooms)
    tmp = Path(root)
    (tmp / "imgs").mkdir(parents=True)
    if frames >= 256:
        _examples().render_walk_parallel(scene, rooms, poses, tmp / "imgs",
                                         workers=min(12, os.cpu_count() or 1))
    else:
        write_png_frames(tmp / "imgs", (render(R, eye) for (R, _t, eye) in poses))

    buf, old_stream = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    t0 = time.time()
    try:
        climain.main(scale_argv(frames, tmp, device, scene=scene, seed=seed,
                                final_ba_iters=final_ba_iters, rooms=rooms))
        _sync(device)
    finally:
        LOGGER._stream = old_stream
    wall = time.time() - t0
    stage_s, recon_detail = {}, {}
    for line in buf.getvalue().splitlines():
        rec = json.loads(line)
        if "wall_s" in rec:
            stage_s[rec["stage"]] = stage_s.get(rec["stage"], 0.0) + rec["wall_s"]
        if rec.get("stage") == "reconstruct":
            recon_detail = {k: rec.get(k) for k in
                            ("ba_path", "components", "phase_s", "ba_iters_per_s", "ba_total_s",
                             "n_rounds", "final_med_px", "ba_call_s", "ba_fallbacks")
                            if rec.get(k) is not None}

    map_path = tmp / "map"
    scene_m = load_scene(map_path, device)
    ref = np.stack([eye for (_, _, eye) in poses]).astype(np.float32)
    rmse, (s_al, R_al, t_al) = umeyama.ate_rmse(scene_m.centers,
                                                torch.as_tensor(ref, device=device),
                                                scene_m.cam_alive)
    n_reg = int(scene_m.cam_alive.sum())
    # the gate scales with the path (a corridor walk is ~5x the room's)
    path_len = float(np.linalg.norm(np.diff(ref, axis=0), axis=1).sum())
    ate_gate = max(0.1, 0.015 * path_len)
    ok = n_reg >= int(0.95 * frames) and float(rmse) < ate_gate

    # retrieval at this map's scale: held-out views (perturbed map poses)
    # must retrieve a keyframe near their true position
    room = _examples()
    lmap = load_localization_map(str(map_path) + ".lmap", device)
    rngq = np.random.default_rng(11)
    q_ids = np.linspace(2, frames - 3, 16).astype(int)
    q_imgs, q_eyes = [], []
    for qi in q_ids:
        Rq, _tq, eye = poses[qi]
        eye2 = eye + rngq.uniform(-0.05, 0.05, 3)
        Rq2, _ = room.look_at(eye2, eye2 + 5.0 * Rq[2])
        q_imgs.append(render(Rq2, eye2))
        q_eyes.append(eye2)
    qcfg = PipelineConfig(features=FeatureConfig(max_keypoints=512),
                          resize_to=(320, 240), focal_factor=0.875)
    qf = extract_features(np.stack(q_imgs), qcfg, device)
    qg = retrieve.vlad_encode(qf.desc, qf.kp.mask, lmap.vocab)
    kfc_world = umeyama.apply_sim3(s_al, R_al, t_al, lmap.kf_centers)
    q_eyes_np = np.stack(q_eyes).astype(np.float32)
    recall8 = retrieve.recall_at_k(lmap.kf_gdesc, kfc_world, lmap.kf_alive, qg, q_eyes_np, k=8)
    strict8 = retrieve.strict_recall_at_k(lmap.kf_gdesc, kfc_world, lmap.kf_alive, qg,
                                          q_eyes_np, k=8)
    return {"config": "2+", "scene": scene, "n_frames": frames, "seed": seed,
            "n_registered": n_reg, "ate_m": float(rmse), "ate_gate_m": ate_gate,
            "path_len_m": path_len, "wall_s": wall, "stage_s": stage_s,
            "recon_detail": recon_detail, "recall_at_8": recall8,
            "strict_recall_at_8": strict8, "pass": bool(ok), "map_path": str(map_path)}


def config2_inputs(n_frames: int = 32):
    """Config 2's ``build_map`` inputs: (images, intrinsics, cam_k, cfg,
    the rendered eyes)."""
    from .cli.config import FeatureConfig, PipelineConfig

    room = _examples()
    poses = room.walk_poses(n_frames)
    imgs = _render_room(room.RoomTexture(seed=7), poses)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=512))
    eyes = np.stack([eye for (_, _, eye) in poses]).astype(np.float32)
    return imgs, _intr(), np.zeros(n_frames, np.int32), cfg, eyes


def config2(device, *, n_frames: int = 32):
    """Config 2: a 32-frame rendered walk through ``build_map`` (its ATE),
    then every frame localized against the map built from it, one
    ``localize_query`` a frame with its RANSAC noise from a generator
    seeded with the frame's index (the reference keys it ``PRNGKey(i)``)."""
    from .cli.pipeline import build_map
    from .localize import build_localization_map, localize_query
    from .solvers import umeyama

    device = torch.device(device)
    imgs, intr, cam_k, cfg, eyes = config2_inputs(n_frames)
    C = n_frames
    t0 = time.time()
    scene, feats, tt, stats = build_map(imgs, intr, cam_k, cfg, device)
    _sync(device)
    build_s = time.time() - t0
    rmse, _ = umeyama.ate_rmse(scene.centers, torch.as_tensor(eyes, device=device),
                               scene.cam_alive)
    lmap = build_localization_map(scene.to_numpy(), feats.desc.cpu().numpy(), tt.obs_feat,
                                  device, kp_mask=feats.kp.mask.cpu().numpy())
    intr0 = torch.as_tensor(intr[0], device=device)
    _sync(device)
    t0 = time.time()
    inl = []
    for i in range(C):
        r = localize_query(lmap, feats.desc[i], feats.kp.uv[i], feats.kp.mask[i], intr0,
                           generator=torch.Generator(device=device).manual_seed(i))
        inl.append(int(r.n_inliers))
    loc_s = time.time() - t0
    return {"config": 2, "n_registered": stats["n_registered"], "n_frames": C,
            "ate_m": float(rmse), "build_s": build_s, "localize_fps": C / loc_s,
            "median_inliers": int(np.median(inl))}


# ---------------------------------------------------------------------------
# Config 3
# ---------------------------------------------------------------------------


def _synthetic_ba(C, P, O, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-5, 5, (C, 2)), np.full((C, 1), 20.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_id = rng.integers(0, C, O).astype(np.int32)
    pt_id = rng.integers(0, P, O).astype(np.int32)
    Xc = X[pt_id] + t[cam_id]
    uv = (Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.asarray([320.0, 240.0])
    uv = (uv + 0.5 * rng.standard_normal((O, 2))).astype(np.float32)
    intr = np.asarray([[500.0, 500.0, 320.0, 240.0, 0, 0, 0]], np.float32)
    return intr, R, t, X, cam_id, pt_id, uv


def config3(device, *, C: int = 512, P: int = 20000, O: int = 200000, iters: int = 20,
            cg_iters: int = 30):
    """Config 3: global BA of a random 512-camera problem through
    ``lm.ba_solve`` as the reference calls it (the planes path: its sums
    on the fixed-order segment-sum kernel), one warm solve, one timed."""
    from .solvers import lm

    device = torch.device(device)
    intr, R, t, X, cam_id, pt_id, uv = _synthetic_ba(C, P, O)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    args = (T(intr), torch.zeros(C, dtype=torch.int32, device=device), T(R), T(t), T(X),
            T(cam_id), T(pt_id), T(uv), torch.ones(O, dtype=torch.float32, device=device),
            T(fixed))
    lm.ba_solve(*args, iters=iters, cg_iters=cg_iters)
    _sync(device)
    t0 = time.time()
    out = lm.ba_solve(*args, iters=iters, cg_iters=cg_iters)
    _sync(device)
    dt = time.time() - t0
    return {"config": 3, "cams": C, "points": P, "obs": O, "lm_iters_per_s": iters / dt,
            "final_cost": float(out[3][-1])}


# ---------------------------------------------------------------------------
# Config 4 and 4-build: a rank a card (mesh.spawn)
# ---------------------------------------------------------------------------


def config4_problem(rng, *, C: int = CONFIG4["C"], P: int = CONFIG4["P"],
                    obs_per_cam: int = CONFIG4["obs_per_cam"]):
    """Config 4's synthetic corridor, the reference's draws from ``rng``
    (``default_rng(1)``): camera c sees a window of 300 points, 0.5 px of
    noise.  Returns (intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed)."""
    O = obs_per_cam * C
    cam_id = np.repeat(np.arange(C, dtype=np.int32), O // C)
    lo = (cam_id.astype(np.int64) * (P - 300) // C).astype(np.int32)
    pt_id = (lo + rng.integers(0, 300, O)).astype(np.int32)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-5, 5, (C, 2)), np.full((C, 1), 20.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    Xc = X[pt_id] + t[cam_id]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.asarray([320.0, 240.0])
          + 0.5 * rng.standard_normal((O, 2))).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    intr = np.asarray([[500.0, 500.0, 320.0, 240.0, 0, 0, 0]], np.float32)
    return (intr, np.zeros(C, np.int32), R, t, X, cam_id, pt_id, uv, np.ones(O, np.float32),
            fixed)


def _write_rank(out_dir: str, rank: int, line: dict, **arrays) -> None:
    """A rank's result: its arrays and launches (npz), rank 0's line (JSON)."""
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    if rank == 0:
        (Path(out_dir) / "line.json").write_text(json.dumps(line))


def _read_ranks(out_dir: str, n: int) -> tuple[dict, list[dict]]:
    """(rank 0's line, every rank's {"digest": of its R, t, X and costs,
    "costs": its cost trace, "launches": counted from 0 over its run})."""
    from .dist.worlds import digest

    ranks = []
    for r in range(n):
        with np.load(Path(out_dir) / f"rank{r}.npz") as z:
            ranks.append({"digest": digest(*(z[k] for k in ("R", "t", "X", "costs"))),
                          "costs": z["costs"].tolist(),
                          "launches": json.loads(str(z["launches"]))})
    return json.loads((Path(out_dir) / "line.json").read_text()), ranks


def _config4_rank(rank: int, n: int, dev, out_dir: str, sizes: dict, iters: int,
                  cg_iters: int) -> None:
    from .dist import block_ba
    from .dist.block_layout import build_block_layout, scatter_cams, scatter_pts
    from .dist.worlds import timed

    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed = config4_problem(
        np.random.default_rng(1), **sizes)
    C, P = R.shape[0], X.shape[0]
    layout = build_block_layout(cam_id, pt_id, uv, w, C, P, n)
    k_l, R_l, t_l, fixed_l = scatter_cams(layout, k_idx, R, t, fixed)
    fixed_l = fixed_l | (layout.cam_global < 0)
    (X_l,) = scatter_pts(layout, X)
    step = block_ba.make_block_ba_step(n_blocks=n, hcap=layout.hcap, device=dev, iters=iters,
                                       cg_iters=cg_iters)
    args = (intr, 1e-4, k_l, R_l, t_l, X_l, fixed_l, layout.obs_cam_l, layout.obs_pt_ext,
            layout.obs_uv, layout.obs_w, layout.halo_idx, layout.halo_mask)
    step(*args)                                            # warm, as the reference
    before = dict(_build.LAUNCHES.counts)
    (R_s, t_s, X_s, costs, _lam), dt = timed(lambda: step(*args), dev)
    launches = _launches_since(before)
    costs = costs.cpu().numpy()
    line = {"config": 4, "cams": C, "points": P, "obs": int(cam_id.shape[0]), "devices": n,
            **layout.stats(), "lm_iters_per_s": iters / dt, "final_cost": float(costs[-1])}
    _write_rank(out_dir, rank, line, R=R_s.cpu().numpy(), t=t_s.cpu().numpy(),
                X=X_s.cpu().numpy(), costs=costs, launches=json.dumps(launches))


def config4(device, *, world_size: int | None = None, backend: str | None = None,
            sizes: dict | None = None, iters: int = CONFIG4["iters"],
            cg_iters: int = CONFIG4["cg_iters"]):
    """Config 4: the 2,048-camera corridor's point-sharded block BA
    (``dist.block_ba``: 1/n of the cameras, points and observations a rank,
    the halo through the collectives) in ``world_size`` spawned ranks
    (``mesh.spawn``'s ``device`` and ``backend``: ``"cuda"`` a card a rank
    under NCCL, ``"cpu"`` gloo ranks); 8 LM iterations x 25 CG steps, one
    warm solve, one timed.  Returns (rank 0's line, every rank's digest
    and launches)."""
    from .dist import mesh

    n = world_size or default_world_size(device)
    with tempfile.TemporaryDirectory(prefix="sfmx_c4_") as out:
        mesh.spawn(_config4_rank, n, out, sizes or {}, iters, cg_iters, device=str(device),
                   backend=backend, timeout=300, join_timeout=3600)
        return _read_ranks(out, n)


def real_scene_problem(map_path):
    """``block_ba_real_scene``'s problem from a scene store: its alive
    observations, unit weights, the unregistered cameras and the first
    registered one held fixed.  Returns (the ba_solve_blocked arguments,
    the number of registered cameras)."""
    from .mapstore.scene import load_scene_np

    s = load_scene_np(map_path, mmap=False)
    alive = s["obs_alive"]
    cam_id, pt_id, uv = s["obs_cam"][alive], s["obs_pt"][alive], s["obs_uv"][alive]
    registered = s["cam_alive"]
    fixed = ~registered
    fixed[np.flatnonzero(registered)[0]] = True
    args = (s["intr"], s["cam_k"], s["cam_R"], s["cam_t"], s["X"], cam_id, pt_id, uv,
            np.ones(len(cam_id), np.float32), fixed)
    return args, int(registered.sum())


def _real_scene_rank(rank: int, n: int, dev, out_dir: str, map_path: str, iters: int,
                     cg_iters: int) -> None:
    from .dist import block_ba

    args, n_cams = real_scene_problem(map_path)
    before = dict(_build.LAUNCHES.counts)
    _sync(dev)
    t0 = time.time()
    R2, t2, X2, costs, stats = block_ba.ba_solve_blocked(*args, device=dev, iters=iters,
                                                         cg_iters=cg_iters)
    _sync(dev)
    wall = time.time() - t0
    launches = _launches_since(before)
    costs = np.asarray(costs)
    line = {"map": map_path, "n_cams": n_cams, "n_pts": int(args[4].shape[0]),
            "n_obs": int(len(args[5])), "n_blocks": n,
            "halo_fraction": stats.get("halo_fraction"),
            **{k: v for k, v in stats.items() if k != "halo_fraction"},
            "cost0": float(costs[0]), "cost_final": float(costs[-1]),
            "cost_monotone_ok": bool(costs[-1] <= costs[0]), "wall_s": wall}
    _write_rank(out_dir, rank, line, R=R2.cpu().numpy(), t=t2.cpu().numpy(),
                X=X2.cpu().numpy(), costs=costs, launches=json.dumps(launches))


def block_ba_real_scene(map_path, device, *, world_size: int | None = None,
                        backend: str | None = None, iters: int = 4, cg_iters: int = 15):
    """Port of ``bench_scripts/block_ba_real_scene.py``: a reconstructed
    scene's real covisibility partitioned over ``world_size`` spawned
    ranks (``device`` and ``backend`` as ``config4``'s) and solved by the
    point-sharded BA (``ba_solve_blocked``); the script's keys (halo
    fraction, the layout's load balance, the cost trajectory, the solve's
    wall with its layout).  Returns (rank 0's line, every rank's digest of
    R, t, X and costs, and its launches)."""
    from .dist import mesh

    n = world_size or default_world_size(device)
    with tempfile.TemporaryDirectory(prefix="sfmx_bbrs_") as out:
        mesh.spawn(_real_scene_rank, n, out, str(map_path), iters, cg_iters,
                   device=str(device), backend=backend, timeout=300, join_timeout=3600)
        return _read_ranks(out, n)


def config4_build(device, root, *, frames: int, scene: str = "room", seed: int = 0,
                  final_ba_iters: int = 0, rooms: int = 4, world_size: int | None = None):
    """Config 4-build: a walk of ``frames`` built by ``config2_scale`` under
    ``root`` (the caller's), then its reconstructed scene partitioned and
    solved by ``block_ba_real_scene`` (4 LM iterations, a card a rank).
    Returns (the line, every rank's digest and launches)."""
    rep = config2_scale(device, root, frames=frames, scene=scene, seed=seed,
                        final_ba_iters=final_ba_iters, rooms=rooms)
    rep["config"] = "4-build"
    rep["block_ba"], ranks = block_ba_real_scene(rep["map_path"], device,
                                                 world_size=world_size, iters=4)
    rep["pass"] = bool(rep["pass"] and rep["block_ba"]["cost_monotone_ok"])
    return rep, ranks


# ---------------------------------------------------------------------------
# Config 5 and 5-serve
# ---------------------------------------------------------------------------


def _synth_descriptors(rng, n_points, dim=128):
    d = rng.normal(size=(n_points, dim)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def scene_features(sc, rng, noise=0.05, K=None):
    """Per-camera features where feature i of camera c observes a landmark
    (``tests/test_matching_tracks.scene_features``, numpy): (uv (C,K,2),
    desc (C,K,D), mask (C,K), feat_pt (C,K) landmark id)."""
    C, P = sc.visible.shape
    K = K or P
    D = 128
    base = _synth_descriptors(rng, P, D)
    uv = np.zeros((C, K, 2), np.float32)
    desc = np.zeros((C, K, D), np.float32)
    mask = np.zeros((C, K), bool)
    feat_pt = np.full((C, K), -1, np.int32)
    for c in range(C):
        ids = np.where(sc.visible[c])[0]
        ids = ids[rng.permutation(len(ids))[:K]]
        n = len(ids)
        uv[c, :n] = sc.uv[c][ids]
        d = base[ids] + noise * rng.normal(size=(n, D)).astype(np.float32)
        desc[c, :n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        mask[c, :n] = True
        feat_pt[c, :n] = ids
    return uv, desc, mask, feat_pt


def session_inputs(sc, cam_range, base_desc_seed=99):
    """A session's features and exhaustive pair list (``tests/test_merge.
    _session``'s inputs): (uv, desc, mask, pairs)."""
    uv, desc, mask, _ = scene_features(sc, np.random.default_rng(base_desc_seed), noise=0.04)
    lo, hi = cam_range
    uv, desc, mask = uv[lo:hi], desc[lo:hi], mask[lo:hi]
    C = hi - lo
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    return uv, desc, mask, pairs


def _session(sc, cam_range, device):
    """``tests/test_merge._session`` on the port: one session of the shared
    synthetic world matched, tracked and reconstructed on ``device``.
    Where the reference calls the dense matcher ``match_pairs_float``, the
    port's is K5's plain version; ``match_pairs_float_auto`` launches K5 on
    a card (and runs that plain version on the CPU), so no plain version
    lies on the path."""
    from .kernels import matching
    from .recon import tracks
    from .recon.incremental import ReconConfig, reconstruct

    uv, desc, mask, pairs = session_inputs(sc, cam_range)
    C = len(uv)
    res = matching.match_pairs_float_auto(torch.as_tensor(desc, device=device),
                                          torch.as_tensor(mask, device=device), pairs)
    tt = tracks.build_tracks(pairs, res.idx.cpu().numpy(), res.valid.cpu().numpy(), C,
                             uv.shape[1])
    scene, _ = reconstruct(uv, mask, tt, sc.intrinsics[None].astype(np.float32),
                           np.zeros(C, np.int32), ReconConfig(), device=device)
    return scene, desc, uv, mask, tt.obs_feat


def config5_world():
    """Config 5's world: ``make_scene(18, 400, 0.3 px, seed 5, 200 deg)``
    and its three overlapping camera ranges."""
    _repo_on_path()
    from tests.synthetic import make_scene

    sc = make_scene(n_cams=18, n_points=400, noise_px=0.3, seed=5, arc_deg=200.0)
    return sc, ((0, 8), (6, 14), (12, 18))


def config5(device):
    """Config 5: three overlapping sessions of a synthetic world, each
    reconstructed alone, then merged (``merge_scenes``: registration graph,
    fusion, joint BA); the merged centers' ATE."""
    from .recon.merge import merge_scenes
    from .solvers import umeyama

    device = torch.device(device)
    sc, spans = config5_world()
    t0 = time.time()
    sessions = [_session(sc, span, device) for span in spans]
    merged, stats = merge_scenes(sessions)
    _sync(device)
    wall = time.time() - t0
    gt = np.concatenate([sc.centers[lo:hi] for lo, hi in spans]).astype(np.float32)
    rmse, _ = umeyama.ate_rmse(merged.centers, torch.as_tensor(gt, device=device),
                               merged.cam_alive)
    return {"config": 5, "sessions": 3, "cams": stats["n_cameras"], "ate_m": float(rmse),
            "wall_s": wall}


def serve_inputs(fps: int):
    """``config5_serve``'s walk, session spans, build config and held-out
    query frames: (poses, spans, cfg, query ids)."""
    from .cli.config import FeatureConfig, MatchConfig, PipelineConfig

    room = _examples()
    total = int(fps * 2.2)
    poses = room.walk_poses(total)
    spans = [(0, fps), (int(0.6 * fps), int(1.6 * fps)), (int(1.2 * fps), total)]
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=512),
                         match=MatchConfig(pair_mode="window", window=max(8, fps // 6)),
                         resize_to=(320, 240), focal_factor=0.875)
    q_ids = np.linspace(3, total - 4, 12).astype(int)
    return poses, spans, cfg, q_ids


def _check_http() -> None:
    """5-serve sends its queries over HTTP: aiohttp's test client to
    ``make_app``, PNG payloads.  Without either package it raises, naming
    it, before anything is built."""
    for pkg, mod in (("aiohttp", "aiohttp"), ("PIL (Pillow)", "PIL")):
        try:
            __import__(mod)
        except ImportError as e:
            raise RuntimeError(f"config 5-serve's HTTP queries need the {pkg} package") from e


async def _serve_http(svc, frames):
    """The reference's transport: PNG payloads POSTed through aiohttp's test
    client to ``make_app``; a warm pass with the same concurrency, then the
    timed one.  Returns (the responses, /stats)."""
    import base64

    from aiohttp.test_utils import TestClient, TestServer
    from PIL import Image

    from .serve import make_app
    from .serve.server import ServiceStats

    payloads = []
    for img in frames:
        buf = io.BytesIO()
        Image.fromarray(quantize(img)).save(buf, format="PNG")
        payloads.append(base64.b64encode(buf.getvalue()).decode())
    async with TestClient(TestServer(make_app(svc))) as client:
        post = lambda pl: client.post("/localize", json={"map_id": "merged", "image": pl})
        await asyncio.gather(*[post(pl) for pl in payloads])
        svc.stats = ServiceStats()
        rs = await asyncio.gather(*[post(pl) for pl in payloads])
        outs = [await r.json() for r in rs]
        st = await (await client.get("/stats")).json()
    return outs, st


def config5_serve(device, *, fps: int):
    """Config 5-serve: three overlapping rendered sessions through
    ``build_map``, merged (``merge_scenes``), the serving map built from
    the merge, saved and reloaded (``lmap_store``), served over 4 map
    shards (``LocalizationService.load_map(shards=4)``: the visible cards,
    round robin), warmed up, and 12 held-out rendered queries POSTed as
    PNGs to the HTTP app; their errors in world units, retrieval recall@8 on the
    merged map and the p95 latency."""
    from .cli.pipeline import build_map, extract_features
    from .localize import retrieve
    from .localize.localize import build_localization_map
    from .mapstore import lmap_store
    from .recon.merge import merge_scenes
    from .serve import LocalizationService
    from .solvers import umeyama

    device = torch.device(device)
    _check_http()
    room = _examples()
    tex = room.RoomTexture(seed=7)
    poses, spans, cfg, q_ids = serve_inputs(fps)
    intr = _intr()
    t0 = time.time()
    sessions = []
    for lo, hi in spans:
        imgs = _render_room(tex, poses[lo:hi])
        scene, feats, tt, _ = build_map(imgs, intr, np.zeros(hi - lo, np.int32), cfg, device)
        sessions.append((scene, feats.desc.cpu().numpy(), feats.kp.uv.cpu().numpy(),
                         feats.kp.mask.cpu().numpy(), tt.obs_feat))
    merged, mstats = merge_scenes(sessions)
    _sync(device)
    build_s = time.time() - t0

    # the serving map of the merged scene (sessions concatenate in order, so
    # per-camera features and per-observation feature ids concatenate too)
    feat_desc = np.concatenate([s[1] for s in sessions])
    kp_mask = np.concatenate([s[3] for s in sessions])
    obs_feat = np.concatenate([np.asarray(s[4]) for s in sessions])
    lmap = build_localization_map(merged.to_numpy(), feat_desc, obs_feat, device,
                                  kp_mask=kp_mask)
    with tempfile.TemporaryDirectory(prefix="sfmx_c5_") as tmp:
        lmap_store.save_localization_map(Path(tmp) / "lmap", lmap)
        lmap = lmap_store.load_localization_map(Path(tmp) / "lmap", device, mmap=False)

    # the merged frame (session 0's) against the rendered eyes
    gt = np.concatenate([np.stack([eye for (_, _, eye) in poses[lo:hi]])
                         for lo, hi in spans]).astype(np.float32)
    ate, (s_al, R_al, t_al) = umeyama.ate_rmse(merged.centers,
                                               torch.as_tensor(gt, device=device),
                                               merged.cam_alive)
    q_imgs = _render_room(tex, [poses[qi] for qi in q_ids])
    qf = extract_features(q_imgs, cfg, device)
    qg = retrieve.vlad_encode(qf.desc, qf.kp.mask, lmap.vocab)
    kfc_world = umeyama.apply_sim3(s_al, R_al, t_al, lmap.kf_centers)
    q_eyes_np = np.stack([poses[qi][2] for qi in q_ids])
    recall8 = retrieve.recall_at_k(lmap.kf_gdesc, kfc_world, lmap.kf_alive, qg, q_eyes_np, k=8)
    strict8 = retrieve.strict_recall_at_k(lmap.kf_gdesc, kfc_world, lmap.kf_alive, qg,
                                          q_eyes_np, k=8)

    svc = LocalizationService(batch_window_ms=10.0, max_batch=8)
    svc.load_map("merged", lmap, intr[0], cfg=cfg, shards=4)
    # every batch bucket built up front: the timed pass measures serving
    svc.warmup("merged")
    outs, st = asyncio.run(_serve_http(svc, q_imgs))
    errs = []
    for qi, out in zip(q_ids, outs):
        c = umeyama.apply_sim3(s_al, R_al, t_al,
                               torch.tensor([out["center"]], dtype=torch.float32,
                                            device=device))
        errs.append(float(np.linalg.norm(c[0].cpu().numpy() - poses[qi][2])))
    errs = np.asarray(errs)
    n_ok = int((errs < 0.25).sum())
    ok = n_ok >= int(0.8 * len(errs)) and float(ate) < 0.1 and recall8 >= 0.9
    return {"config": "5-serve", "sessions": 3, "frames_per_session": fps,
            "cams": mstats["n_cameras"], "points": mstats["n_points"],
            "merge_pair_inliers": mstats.get("pair_inliers"),
            "joint_ba_cost": mstats.get("joint_ba_cost"),
            "merged_ate_m": float(ate), "recall_at_8": recall8,
            "strict_recall_at_8": strict8, "query_err_median_m": float(np.median(errs)),
            "queries_ok": f"{n_ok}/{len(errs)}", "latency_p95_ms": st.get("p95_latency_ms"),
            "shards": 4, "build_s": build_s, "pass": bool(ok)}


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def run(config: int, device, *, frames: int = 32, scene: str = "room", seed: int = 0,
        final_ba_iters: int = 0, rooms: int = 4, world_size: int | None = None):
    """Dispatch as the reference does (config 2 past 32 frames runs 2+,
    config 4 from 256 frames 4-build, config 5 from 48 frames 5-serve).
    2+ and 4-build work in a temporary directory, removed when they
    return (the line's ``map_path`` names where the map was).  Returns
    (the line, every spawned rank's digest and launches: empty where the
    config spawns no ranks)."""
    scale = dict(scene=scene, seed=seed, final_ba_iters=final_ba_iters, rooms=rooms)
    if config == 1:
        return config1(device), []
    if config == 2:
        if frames > 32:
            with tempfile.TemporaryDirectory(prefix="sfmx_c2_") as root:
                return config2_scale(device, root, frames=frames, **scale), []
        return config2(device), []
    if config == 3:
        return config3(device), []
    if config == 4:
        if frames >= 256:
            with tempfile.TemporaryDirectory(prefix="sfmx_c4b_") as root:
                return config4_build(device, root, frames=frames, world_size=world_size,
                                     **scale)
        return config4(device, world_size=world_size)
    if config == 5:
        if frames >= 48:
            return config5_serve(device, fps=frames), []
        return config5(device), []
    raise ValueError(f"config must be 1-5, not {config}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m sfmx_torch.run_configs",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=int, required=True, choices=(1, 2, 3, 4, 5))
    p.add_argument("--frames", type=int, default=32,
                   help="config 2: walk length (> 32: the streaming CLI build, 2+); "
                        "config 4: >= 256 builds the scene (4-build); config 5: >= 48 "
                        "frames a session (5-serve)")
    p.add_argument("--scene", default="room", choices=["room", "corridor"])
    p.add_argument("--seed", type=int, default=0, help="reconstruction seed")
    p.add_argument("--final-ba-iters", type=int, default=0,
                   help="final BA iterations (0: the config's default)")
    p.add_argument("--rooms", type=int, default=4, help="corridor rooms")
    p.add_argument("--device", default="cuda")
    p.add_argument("--world-size", type=int, default=None,
                   help="config 4's ranks (default: the visible cards; 1 on the CPU)")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    before = dict(_build.LAUNCHES.counts)
    line, ranks = run(a.config, device, frames=a.frames, scene=a.scene, seed=a.seed,
                      final_ba_iters=a.final_ba_iters, rooms=a.rooms, world_size=a.world_size)
    line["device"] = device_info(device)
    print(json.dumps({"launches": _launches_since(before),
                      "rank_launches": [r["launches"] for r in ranks]}),
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    # guarded: spawned renderers and ranks import this module
    main()
