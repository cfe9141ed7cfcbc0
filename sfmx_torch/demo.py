"""End-to-end demo on the port: rendered images -> map -> localization -> ATE
(port of ``examples/demo_pipeline.py``, the same scene and gate).

Renders a textured room from a walkthrough camera arc (``examples/room.py``),
then runs the public pipeline on ``--device``:
  detect_and_describe -> match_pairs_float -> verify_matches -> build_tracks
  -> reconstruct -> save/load the scene store -> evaluate_trajectory ->
  localize_query of held-out renders.
Prints ``DEMO: PASS`` when every camera but at most one registered, the
trajectory's ATE is < 0.1 m and every query lies within 0.2 m with >= 12
inliers; else ``DEMO: FAIL`` (exit code 1).

Usage: python -m sfmx_torch.demo [--device cpu|cuda] [--cams 12] [--queries 2]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 240, 320
FOCAL = 280.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m sfmx_torch.demo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cams", type=int, default=12)
    p.add_argument("--queries", type=int, default=2)
    args = p.parse_args(argv)
    # the renderer lives in the repository's examples/
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.room import RoomTexture, look_at, render_room, walk_poses

    from .cli.config import PipelineConfig
    from .cli.evaluate import evaluate_trajectory, scene_stats
    from .cli.pipeline import verify_matches
    from .kernels import features, matching
    from .localize import build_localization_map, localize_query
    from .mapstore.scene import load_scene, save_scene
    from .recon import tracks
    from .recon.incremental import ReconConfig, reconstruct
    from .solvers import umeyama

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    tex = RoomTexture(seed=3)
    C = args.cams
    t0 = time.time()
    poses = walk_poses(C)
    images = np.stack([render_room(tex, R, eye, W, H, FOCAL) for (R, t, eye) in poses])
    print(f"[render] {C} room images {W}x{H} in {time.time() - t0:.1f}s")

    batch = torch.as_tensor(images, dtype=torch.float32, device=dev)
    t0 = time.time()
    feats = features.detect_and_describe(batch, max_keypoints=512, threshold=1e-7)
    print(f"[features] keypoints/image: {feats.kp.mask.sum(dim=1).tolist()} "
          f"in {time.time() - t0:.1f}s")

    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    t0 = time.time()
    res = matching.match_pairs_float(feats.desc, feats.kp.mask, pairs, ratio=0.85)
    print(f"[match] {int(res.valid.sum())} raw matches over {len(pairs)} pairs "
          f"in {time.time() - t0:.1f}s")

    intr = np.array([[FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0]], np.float32)
    cam_k = np.zeros(C, np.int32)
    t0 = time.time()
    res, _ = verify_matches(feats, pairs, res, intr, cam_k, PipelineConfig(), generator=gen)
    print(f"[verify] {int(res.valid.sum())} geometric inliers in {time.time() - t0:.1f}s")
    valid = res.valid.cpu().numpy()
    tt = tracks.build_tracks(pairs, res.idx.cpu().numpy(), valid, C, 512)
    print(f"[tracks] {tt.n_tracks} tracks, {len(tt.obs_cam)} observations")

    t0 = time.time()
    scene, stats = reconstruct(feats.kp.uv.cpu().numpy(), feats.kp.mask.cpu().numpy(), tt,
                               intr, cam_k, ReconConfig(px_thresh=4.0, min_init_inliers=20),
                               pair_counts=(pairs, valid.sum(1)), device=dev)
    print(f"[recon] registered {stats['n_registered']}/{C} cams, "
          f"{stats['n_points']} points in {time.time() - t0:.1f}s")
    print("[recon] stats:", scene_stats(scene))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo_scene")
        save_scene(path, scene)
        scene = load_scene(path, dev)
    print("[mapstore] save/load roundtrip ok")

    ref_centers = np.stack([eye for (_, _, eye) in poses])
    report = evaluate_trajectory(scene.centers, ref_centers, scene.cam_alive, device=dev)
    print("[evaluate]", report)

    # held-out queries: new poses between cameras, rendered and extracted
    lmap = build_localization_map(scene.to_numpy(), feats.desc.cpu().numpy(), tt.obs_feat,
                                  dev)
    ref_t = torch.as_tensor(ref_centers, dtype=torch.float32, device=dev)
    s, R, t = umeyama.umeyama(scene.centers, ref_t, scene.cam_alive)
    intr0 = torch.as_tensor(intr[0], device=dev)
    ok = 0
    for qi in range(args.queries):
        si = 0.3 + 0.35 * qi
        eye = np.array([-3.0 + 6.0 * si + 0.15, 0.2 * np.sin(6 * si) + 0.05, -3.0 + 2.0 * si])
        yaw = np.deg2rad(25.0 + 20.0 * si + 4.0)
        d = np.array([np.sin(yaw), 0.12 * np.sin(4 * si), np.cos(yaw)])
        Rq, _tq = look_at(eye, eye + 5.0 * d)
        qimg = render_room(tex, Rq, eye, W, H, FOCAL)
        qf = features.detect_and_describe(
            torch.as_tensor(qimg[None], dtype=torch.float32, device=dev),
            max_keypoints=512, threshold=1e-7)
        t0 = time.time()
        resq = localize_query(lmap, qf.desc[0], qf.kp.uv[0], qf.kp.mask[0], intr0,
                              generator=gen, sim_thresh=0.7)
        # the estimated center in the world frame through the trajectory's alignment
        cw = umeyama.apply_sim3(s, R, t, resq.center[None]).cpu().numpy()[0]
        err = np.linalg.norm(cw - eye)
        print(f"[localize] query {qi}: inliers={int(resq.n_inliers)} "
              f"conf={float(resq.confidence):.2f} pos_err={err:.3f}m "
              f"({time.time() - t0:.2f}s)")
        ok += err < 0.2 and int(resq.n_inliers) >= 12
    print(f"[localize] {ok}/{args.queries} queries within 0.2m")
    # tail frames may lack two-view coverage; one dropout is tolerated
    if stats["n_registered"] < C - 1 or report["ate_rmse"] > 0.1 or ok < args.queries:
        print("DEMO: FAIL")
        return 1
    print("DEMO: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
