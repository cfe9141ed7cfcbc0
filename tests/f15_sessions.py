"""Config 5-serve's three rendered sessions built end to end by each package
on the CPU and merged by that package's ``merge_scenes``: the reference's
builds (``sfmx.cli.pipeline.build_map``) beside the port's
(``sfmx_torch.cli.pipeline.build_map``) on the same rendered frames,
spans and pipeline config (``sfmx_torch.run_configs.serve_inputs``, held
to ``bench/run_configs.py:config5_serve``'s by
``tests/test_torch_run_configs.py``).  For each session it prints the
registered cameras and the alive landmarks: how many lie more than 30 m
from their median and the farthest (the stretch that loosens the merge's
verified registration), then the merge's outcome: the merged cameras and
the ATE of their centers against the rendered eyes, or the error it
raised.

Run from the repository root (~10 min a package at 128 frames a session):
    JAX_PLATFORMS=cpu python3 tests/f15_sessions.py [frames a session [ref|port|both]]
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def far_landmarks(X, alive) -> dict:
    X = np.asarray(X)[np.asarray(alive)]
    d = np.linalg.norm(X - np.median(X, 0), axis=1)
    return {"alive": int(len(X)), "beyond_30m": int((d > 30.0).sum()),
            "farthest_m": float(d.max()), "extent_m": float(np.linalg.norm(X.max(0) - X.min(0)))}


def reference_build(imgs, intr, cfg_kw):
    from sfmx.cli.config import FeatureConfig, MatchConfig, PipelineConfig
    from sfmx.cli.pipeline import build_map

    cfg = PipelineConfig(features=FeatureConfig(**cfg_kw["features"]),
                         match=MatchConfig(**cfg_kw["match"]), resize_to=cfg_kw["resize_to"],
                         focal_factor=cfg_kw["focal_factor"])
    scene, feats, tt, stats = build_map(imgs, intr, np.zeros(len(imgs), np.int32), cfg)
    return (scene, np.asarray(feats.desc), np.asarray(feats.kp.uv),
            np.asarray(feats.kp.mask), tt.obs_feat), stats, scene.X, scene.X_alive


def port_build(imgs, intr, cfg):
    from sfmx_torch.cli.pipeline import build_map

    scene, feats, tt, stats = build_map(imgs, intr, np.zeros(len(imgs), np.int32), cfg, "cpu")
    return (scene, feats.desc.numpy(), feats.kp.uv.numpy(), feats.kp.mask.numpy(),
            tt.obs_feat), stats, scene.X.numpy(), scene.X_alive.numpy()


def run(package: str, fps: int) -> dict:
    import torch

    from sfmx_torch import run_configs as rc

    if package == "reference":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfmx.recon.merge import merge_scenes
        from sfmx.solvers import umeyama

        build = lambda imgs, intr, cfg: reference_build(imgs, intr, {  # noqa: E731
            "features": {"max_keypoints": cfg.features.max_keypoints},
            "match": {"pair_mode": cfg.match.pair_mode, "window": cfg.match.window},
            "resize_to": cfg.resize_to, "focal_factor": cfg.focal_factor})
        as_array = np.asarray
    else:
        from sfmx_torch.recon.merge import merge_scenes
        from sfmx_torch.solvers import umeyama

        build = port_build
        as_array = torch.as_tensor
    room = rc._examples()
    tex = room.RoomTexture(seed=7)
    poses, spans, cfg, _q = rc.serve_inputs(fps)
    intr = rc._intr()
    out = {"package": package, "frames_per_session": fps, "sessions": []}
    sessions = []
    for lo, hi in spans:
        t0 = time.perf_counter()
        session, stats, X, alive = build(rc._render_room(tex, poses[lo:hi]), intr, cfg)
        sessions.append(session)
        out["sessions"].append({"span": [lo, hi], "registered": int(stats["n_registered"]),
                                **far_landmarks(X, alive),
                                "wall_s": time.perf_counter() - t0})
        print(json.dumps(out["sessions"][-1]), flush=True)
    try:
        merged, mstats = merge_scenes(sessions)
    except Exception as e:                    # the outcome to report, not a pass
        out["merge"] = {"error": f"{type(e).__name__}: {e}"}
        return out
    gt = np.concatenate([np.stack([eye for (_, _, eye) in poses[lo:hi]])
                         for lo, hi in spans]).astype(np.float32)
    ate, _ = umeyama.ate_rmse(merged.centers, as_array(gt), merged.cam_alive)
    out["merge"] = {"cams": int(mstats["n_cameras"]), "ate_m": float(ate)}
    return out


def main() -> int:
    fps = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    which = sys.argv[2] if len(sys.argv) > 2 else "both"
    packages = {"ref": ["reference"], "port": ["port_cpu"],
                "both": ["reference", "port_cpu"]}[which]
    for package in packages:
        print(json.dumps(run(package, fps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
