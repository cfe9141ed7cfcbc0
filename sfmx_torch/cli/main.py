"""The port's command line (port of ``sfmx.cli.main``):
``python -m sfmx_torch.cli.main <command> ...`` with build-map, localize,
merge, serve, georeference, evaluate, export, bench, bundle and unbundle.

Every subcommand takes ``--device`` (default ``cuda``); without a card and
without ``--device cpu`` it fails with torch's own error.  Each command's
body is split into its decode (``ingest``) and what follows it
(``build_map_store``, ``localize_workspace``), which the functions below
also offer to callers who hold decoded images:

- ``build_map_store`` / ``build_map_store_streaming``: the map build, then
  the scene store, ``<map>.feats.npz`` and the serving map ``<map>.lmap``;
- ``localize_images``: the batch branch of ``localize``: extract every
  image, then localize fixed 16-frame chunks (the last one padded by
  repeating its final image) on the streaming path (kernel K4) where
  ``use_streaming`` says so, else on the gather path (Hamming matching for
  binary maps);
- ``localize_sequence_images``: its ``--sequential`` branch (tracking);
- ``load_lmap``: a scene store and its serving map;
- ``make_service``/``serve``: the body of ``serve``.

Random draws: where the reference draws ``jax.random.PRNGKey(s)``, the port
seeds one ``torch.Generator`` on the device from ``s`` (0 for a command), so
its draws are not the reference's.  Not ported: the compile-cache plumbing
(``--cache``/``--no-cache`` of ``bundle``, the ``jax_cache`` member of a
bundle, ``_merge_cache``, ``_enable_compile_cache``), which ships or pins
XLA's compile cache.  ``bench`` runs ``sfmx_torch.bench`` (the port of
``bench.py``) in this process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..localize.localize import (LocalizationMap, build_localization_map,
                                 localize_batch, localize_batch_streaming, use_streaming)
from ..mapstore.lmap_store import has_localization_map, load_localization_map
from ..mapstore.scene import load_scene_np
from .config import PipelineConfig, load_config
from .pipeline import extract_features

CHUNK = 16


def _result_dict(res, i: int) -> dict:
    return {"R": res.R[i].tolist(), "t": res.t[i].tolist(), "center": res.center[i].tolist(),
            "n_inliers": int(res.n_inliers[i]), "confidence": float(res.confidence[i])}


def localize_images(images, intr, lmap: LocalizationMap, cfg: PipelineConfig, *,
                    generator: torch.Generator | None = None,
                    gumbel: Sequence[torch.Tensor] | None = None) -> list[dict]:
    """Localize (N,H,W) images in [0,1] against ``lmap`` on its device.

    intr: (7,) intrinsics shared by all images.  ``gumbel`` optionally holds
    one (chunk, k_hypotheses, K) RANSAC noise tensor per chunk; otherwise
    noise is drawn from ``generator``.  Returns one dict per image with
    R, t, center, n_inliers and confidence.
    """
    lc = cfg.localize
    binary = lc.binary and lmap.lm_bits is not None
    streaming = use_streaming(lc, lmap, binary)
    device = lmap.X.device
    feats = extract_features(images, cfg, device)
    intr0 = torch.as_tensor(np.asarray(intr, np.float32)).to(device)
    n = len(images)
    chunk = min(CHUNK, max(1, n))
    out = []
    for c, s in enumerate(range(0, n, chunk)):
        idx = np.arange(s, min(s + chunk, n))
        pad = torch.as_tensor(np.concatenate([idx, np.full(chunk - len(idx), idx[-1])]),
                              device=device)
        d, u, m = feats.desc[pad], feats.kp.uv[pad], feats.kp.mask[pad]
        noise = dict(generator=generator, gumbel=None if gumbel is None else gumbel[c])
        if streaming:
            res = localize_batch_streaming(
                lmap, d, u, m, intr0, **noise, k_hypotheses=lc.k_hypotheses,
                px_thresh=lc.px_thresh, ratio=cfg.match.ratio, sim_thresh=lc.sim_thresh,
                min_inliers=lc.min_inliers, pnp_solver=lc.pnp_solver)
        else:
            res = localize_batch(
                lmap, d, u, m, intr0, **noise,
                q_bits=feats.desc_bits[pad] if binary else None,
                top_k_kf=lc.top_k_kf, m_cap=lc.m_cap, k_hypotheses=lc.k_hypotheses,
                px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
                min_inliers=lc.min_inliers, ham_thresh=lc.ham_thresh,
                pnp_solver=lc.pnp_solver)
        res = type(res)(*(x.cpu() for x in res))
        out.extend(_result_dict(res, i) for i in range(len(idx)))
    return out


def localize_sequence_images(images, intr, lmap: LocalizationMap, cfg: PipelineConfig, *,
                             radius: float = 3.0,
                             generator: torch.Generator | None = None,
                             gumbel: torch.Tensor | None = None) -> dict:
    """Continuous tracking over an image sequence: each pose's center gates
    the next frame's retrieval and lost tracks relocalize globally.
    ``gumbel`` (N,k_hypotheses,K) optionally holds each frame's RANSAC noise.
    Returns {"stats": ..., "frames": [per-frame dict with "tracked"]}."""
    from ..localize.tracking import TrackingConfig, localize_sequence

    lc = cfg.localize
    feats = extract_features(images, cfg, lmap.X.device)
    tcfg = TrackingConfig(
        radius=radius, min_inliers=lc.min_inliers, top_k_kf=lc.top_k_kf, m_cap=lc.m_cap,
        k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
        sim_thresh=lc.sim_thresh, pnp_solver=lc.pnp_solver)
    results, flags, stats = localize_sequence(
        lmap, feats.desc, feats.kp.uv, feats.kp.mask, np.asarray(intr, np.float32), tcfg,
        gumbel=gumbel, generator=generator)
    frames = []
    for r, f in zip(results, flags):
        one = type(r)(*(x.cpu()[None] for x in r))
        frames.append({**_result_dict(one, 0), "tracked": bool(f)})
    return {"stats": stats, "frames": frames}


def load_lmap(map_path: str | Path, device, *, binary: bool = False):
    """Load the scene store at ``map_path`` and its serving map onto
    ``device``: the persisted ``<map>.lmap`` when present (and holding bits
    if ``binary``), else one aggregated from ``<map>.feats.npz``.
    Returns (scene columns, LocalizationMap)."""
    scene = load_scene_np(map_path)
    lmap_path = f"{map_path}.lmap"
    if has_localization_map(lmap_path):
        lmap = load_localization_map(lmap_path, device)
        if not binary or lmap.lm_bits is not None:
            return scene, lmap
        # binary serving requested but the store predates bits: fall through
    z = np.load(f"{map_path}.feats.npz")
    bits = z["desc_bits"] if (binary and "desc_bits" in z.files) else None
    lmap = build_localization_map(scene, z["desc"], z["obs_feat"], device,
                                  kp_mask=z["kp_mask"], feat_bits=bits)
    return scene, lmap


def make_service(map_specs: Sequence[str], cfg: PipelineConfig, device, *,
                 batch_window_ms: float = 5.0, max_batch: int = 32, shards: int = 1,
                 warmup: bool = True):
    """A LocalizationService with every map of ``map_specs`` ("id=path" or
    "path") loaded on ``device`` and, unless ``warmup`` is False, warmed up."""
    from ..serve import LocalizationService

    service = LocalizationService(batch_window_ms=batch_window_ms, max_batch=max_batch)
    for spec in map_specs:
        map_id, path = spec.split("=", 1) if "=" in spec else (spec, spec)
        scene, lmap = load_lmap(path, device, binary=cfg.localize.binary)
        service.load_map(map_id, lmap, np.asarray(scene["intr"])[0], cfg=cfg, shards=shards)
        if warmup:
            service.warmup(map_id)
    return service


def serve(map_specs: Sequence[str], cfg: PipelineConfig, device, *, port: int = 8080,
          batch_window_ms: float = 5.0, max_batch: int = 32, shards: int = 1,
          warmup: bool = True):
    """Serve the maps over HTTP until interrupted (``sfmx serve``).

    Prints one JSON line when the maps are loaded and warmed up (each map's
    devices and landmarks, the kernel launches so far) and one when the
    server has stopped (SIGINT or SIGTERM): the launches since the process
    started and the serving stats."""
    from aiohttp import web

    from ..kernels import _build
    from ..serve import make_app
    from ..serve.router import MapShardRouter

    service = make_service(map_specs, cfg, device, batch_window_ms=batch_window_ms,
                           max_batch=max_batch, shards=shards, warmup=warmup)
    placement = {}
    for map_id, (lmap, _intr, _cfg) in service.maps.items():
        parts = list(zip(lmap.devices, lmap.shards)) if isinstance(lmap, MapShardRouter) \
            else [(lmap.X.device, lmap)]
        placement[map_id] = [{"device": str(d), "landmarks": int(m.X.shape[0])}
                             for d, m in parts]
    print(json.dumps({"serve": "loaded", "port": port, "maps": placement,
                      "launches": dict(_build.LAUNCHES.counts)}), flush=True)
    web.run_app(make_app(service), port=port)
    print(json.dumps({"serve": "stopped", "launches": dict(_build.LAUNCHES.counts),
                      "stats": service.stats.snapshot()}), flush=True)


# ---------------------------------------------------------------------------
# build-map
# ---------------------------------------------------------------------------


def _save_map(out: str, scene, feats, tt, stats: dict, image_paths, device) -> dict:
    """Write the scene store, ``<out>.feats.npz`` (per-feature descriptors and
    obs_feat, for merging) and the serving map ``<out>.lmap`` (landmark
    descriptors, VLAD vocabulary, keyframe global descriptors, majority-vote
    bits), so localize and serve start by loading it.  Returns the command's
    result record."""
    from ..mapstore.lmap_store import save_localization_map
    from ..mapstore.scene import save_scene

    extra = {"image_paths": list(image_paths),
             "stats": {k: v for k, v in stats.items() if isinstance(v, (int, float, list))}}
    save_scene(out, scene, extra=extra)
    f = feats.to_numpy()
    np.savez_compressed(out + ".feats.npz", desc=f.desc, kp_uv=f.kp.uv, kp_mask=f.kp.mask,
                        obs_feat=tt.obs_feat, desc_bits=f.desc_bits)
    lmap = build_localization_map(scene.to_numpy(), f.desc, tt.obs_feat, device,
                                  kp_mask=f.kp.mask,
                                  feat_bits=f.desc_bits if f.desc_bits.size else None)
    save_localization_map(out + ".lmap", lmap)
    return {"registered": stats["n_registered"], "points": stats["n_points"], "output": out}


def build_map_store(ws, out: str, cfg: PipelineConfig, device, *, workdir=None) -> dict:
    """``build-map`` after decoding: ``build_map`` of a decoded
    ``ingest.Workspace`` on ``device`` (verification's RANSAC draws from a
    generator seeded 0), then the map's three artifacts at ``out``."""
    from .pipeline import build_map

    gen = torch.Generator(device=device).manual_seed(0)
    scene, feats, tt, stats = build_map(ws.images, ws.intrinsics, ws.cam_k, cfg, device,
                                        workdir, generator=gen)
    return _save_map(out, scene, feats, tt, stats, ws.image_paths, device)


def build_map_store_streaming(paths, out: str, cfg: PipelineConfig, device, *,
                              chunk: int = 16, workdir=None) -> dict:
    """``build-map --stream``: decode and extraction pipelined
    (``extract_features_streaming``), never holding the full image set in
    host memory; the stage cache is keyed by each file's path, size and
    mtime, so modified files never pair stale matches with fresh features."""
    from . import ingest
    from .pipeline import build_map, extract_features_streaming

    paths = [str(p) for p in paths]
    feats, _sizes = extract_features_streaming(paths, cfg, device, chunk=chunk,
                                               resize_to=cfg.resize_to)
    W, H = cfg.resize_to
    intr = ingest.default_intrinsics(W, H, cfg.focal_factor)[None]
    f = ingest.exif_focal_px(paths[0], W)  # the same focal prior as the eager path
    if f is not None:
        intr[0, 0] = intr[0, 1] = f
    evidence = ";".join(f"{p}:{(st := os.stat(p)).st_size}:{st.st_mtime_ns}" for p in paths)
    gen = torch.Generator(device=device).manual_seed(0)
    scene, feats, tt, stats = build_map(None, intr, np.zeros(len(paths), np.int32), cfg,
                                        device, workdir, feats=feats, stage_seed=evidence,
                                        generator=gen)
    return _save_map(out, scene, feats, tt, stats, paths, device)


def cmd_build_map(args):
    from . import ingest

    cfg = load_config(args.config, args.override or [])
    dev = torch.device(args.device)
    if args.stream and args.video:
        raise SystemExit("--stream is directory-only; it cannot be combined "
                         "with --video (frame extraction already streams)")
    if args.chunk != 16 and not args.stream:
        print("warning: --chunk has no effect without --stream", file=sys.stderr)
    if args.stream:
        rec = build_map_store_streaming(ingest.list_images(args.images), args.output, cfg,
                                        dev, chunk=args.chunk, workdir=args.workdir)
    else:
        if args.video:
            ws = ingest.load_video(args.images, every_n=args.every_n,
                                   resize_to=cfg.resize_to, focal_factor=cfg.focal_factor)
        else:
            ws = ingest.load_directory(args.images, resize_to=cfg.resize_to,
                                       focal_factor=cfg.focal_factor)
        rec = build_map_store(ws, args.output, cfg, dev, workdir=args.workdir)
    print(json.dumps(rec))


# ---------------------------------------------------------------------------
# localize, merge, serve
# ---------------------------------------------------------------------------


def localize_workspace(map_path: str, ws, cfg: PipelineConfig, device, *,
                       sequential: bool = False, radius: float = 3.0):
    """``localize`` after decoding: the decoded query workspace against the
    map at ``map_path`` on ``device``; RANSAC noise from one generator
    seeded 0.  Returns the batch list, or the tracking record."""
    _scene, lmap = load_lmap(map_path, device, binary=cfg.localize.binary)
    gen = torch.Generator(device=device).manual_seed(0)
    intr = ws.intrinsics[0]
    if sequential:
        rec = localize_sequence_images(ws.images, intr, lmap, cfg, radius=radius,
                                       generator=gen)
        rec["frames"] = [{"image": p, **r} for p, r in zip(ws.image_paths, rec["frames"])]
        return rec
    res = localize_images(ws.images, intr, lmap, cfg, generator=gen)
    return [{"image": p, **r} for p, r in zip(ws.image_paths, res)]


def cmd_localize(args):
    from . import ingest

    cfg = load_config(args.config, args.override or [])
    if args.video:
        ws = ingest.load_video(args.images, every_n=args.every_n, resize_to=cfg.resize_to,
                               focal_factor=cfg.focal_factor)
    else:
        ws = ingest.load_directory(args.images, resize_to=cfg.resize_to,
                                   focal_factor=cfg.focal_factor)
    out = localize_workspace(args.map, ws, cfg, torch.device(args.device),
                             sequential=args.sequential, radius=args.radius)
    print(json.dumps(out, indent=2))


def cmd_merge(args):
    """Session stores (each with its ``.feats.npz``) merged on the device by
    ``recon.merge.merge_scenes``."""
    from ..mapstore.scene import load_scene, save_scene
    from ..recon.merge import merge_scenes

    dev = torch.device(args.device)
    sessions = []
    for p in args.maps:
        z = np.load(p + ".feats.npz")
        sessions.append((load_scene(p, dev), z["desc"], z["kp_uv"], z["kp_mask"],
                         z["obs_feat"]))
    merged, stats = merge_scenes(sessions)
    save_scene(args.output, merged, extra={"merge_stats": stats})
    print(json.dumps({"output": args.output, **stats}))


def cmd_serve(args):
    cfg = load_config(args.config, args.override or [])
    serve(args.map, cfg, torch.device(args.device), port=args.port,
          batch_window_ms=args.batch_window_ms, max_batch=args.max_batch, shards=args.shards,
          warmup=not args.no_warmup)


# ---------------------------------------------------------------------------
# georeference, evaluate, export
# ---------------------------------------------------------------------------


def cmd_georeference(args):
    """Align a map to world coordinates through control points: a JSON file
    of [[cam_index, wx, wy, wz], ...], known positions of some cameras.  The
    similarity (``umeyama`` on the device) moves the whole scene, as merge
    does; the store is written to ``-o`` (default: in place)."""
    from ..mapstore.scene import load_scene, save_scene
    from ..recon.merge import transform_scene_inplace
    from ..solvers import umeyama

    dev = torch.device(args.device)
    scene = load_scene(args.map, dev)
    ctrl = np.asarray(json.loads(Path(args.control).read_text()), np.float64)
    idx = torch.as_tensor(ctrl[:, 0].astype(np.int64), device=dev)
    world = torch.as_tensor(ctrl[:, 1:4], dtype=torch.float32, device=dev)
    s_, R_, t_ = umeyama.umeyama(scene.centers[idx], world)
    cols = scene.to_numpy()
    R2, t2, X2 = transform_scene_inplace(cols["cam_R"], cols["cam_t"], cols["X"], float(s_),
                                         R_.cpu().numpy(), t_.cpu().numpy())
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    scene = dataclasses.replace(scene, cam_R=t(R2), cam_t=t(t2), X=t(X2))
    out = args.output or args.map
    save_scene(out, scene, extra={"georeferenced": True, "scale": float(s_)})
    resid = torch.linalg.vector_norm(scene.centers[idx] - world, dim=1)
    print(json.dumps({"output": out, "scale": float(s_),
                      "control_rmse": float(torch.sqrt(torch.mean(resid ** 2)))}))


def cmd_evaluate(args):
    """Scene statistics and, given a text file of (C,3) true centers, the
    trajectory's ATE, on the device."""
    from ..mapstore.scene import load_scene
    from .evaluate import evaluate_trajectory, print_report, scene_stats

    dev = torch.device(args.device)
    scene = load_scene(args.map, dev)
    report = {"scene": scene_stats(scene)}
    if args.reference:
        report["trajectory"] = evaluate_trajectory(scene.centers, np.loadtxt(args.reference),
                                                   scene.cam_alive, device=dev)
    print_report(report)


def cmd_export(args):
    from ..mapstore.scene import load_scene
    from .export import export_scene_ply

    scene = load_scene(args.map, torch.device(args.device))
    out = args.output or (str(args.map).rstrip("/") + ".ply")
    print(json.dumps(export_scene_ply(scene, out, frustum_scale=args.frustum_scale)))


# ---------------------------------------------------------------------------
# bundle / unbundle
# ---------------------------------------------------------------------------


def cmd_bench(args):
    from .. import bench

    bench.main(args.device)


def cmd_bundle(args):
    """Package a deployable artifact: the map's store, its serving map and
    its features (the map artifacts only; no compile cache)."""
    import tarfile

    base = os.path.basename(args.map.rstrip("/"))
    n_map = 0
    with tarfile.open(args.output, "w:gz") as tar:
        for suffix in ("", ".lmap", ".feats.npz"):
            pth = args.map.rstrip("/") + suffix
            if os.path.exists(pth):
                tar.add(pth, arcname="map/" + base + suffix)
                n_map += 1
        if n_map == 0:
            raise SystemExit(f"no map artifacts found at {args.map}")
    print(json.dumps({"output": args.output, "map": base, "map_artifacts": n_map,
                      "size_mb": round(os.path.getsize(args.output) / 1e6, 1)}))


def cmd_unbundle(args):
    import tarfile

    os.makedirs(args.dest, exist_ok=True)
    with tarfile.open(args.bundle, "r:gz") as tar:
        tar.extractall(args.dest, filter="data")
    maps = sorted(p for p in os.listdir(os.path.join(args.dest, "map"))
                  if not (p.endswith(".lmap") or p.endswith(".npz")))
    print(json.dumps({"maps": [os.path.join(args.dest, "map", m) for m in maps]}))


# ---------------------------------------------------------------------------
# argparse
# ---------------------------------------------------------------------------

_NOT_PORTED = ("Not in the port: the compile-cache flags of bundle (--cache, --no-cache) and "
               "the bundle's jax_cache member ship or pin XLA's compile cache.")


def main(argv=None):
    p = argparse.ArgumentParser(prog="sfmx_torch", epilog=_NOT_PORTED)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
        sp.set_defaults(fn=fn)
        return sp

    b = add("build-map", cmd_build_map, help="reconstruct a map from images/video")
    b.add_argument("images")
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--video", action="store_true")
    b.add_argument("--every-n", type=int, default=10)
    b.add_argument("--workdir", default=None, help="stage-cache directory")
    b.add_argument("--stream", action="store_true",
                   help="pipelined decode and extraction (bounded host memory)")
    b.add_argument("--chunk", type=int, default=16, help="streaming chunk size")
    b.add_argument("--config", default=None)
    b.add_argument("--override", "-D", action="append", help="key=value")

    l = add("localize", cmd_localize, help="localize query images against a map")
    l.add_argument("map")
    l.add_argument("images", help="image directory, or video file with --video")
    l.add_argument("--video", action="store_true")
    l.add_argument("--every-n", type=int, default=10, help="video frame stride")
    l.add_argument("--sequential", action="store_true",
                   help="continuous tracking: prior-gated retrieval + relocalization")
    l.add_argument("--radius", type=float, default=3.0,
                   help="tracking prior radius (map units)")
    l.add_argument("--config", default=None)
    l.add_argument("--override", "-D", action="append")

    m = add("merge", cmd_merge, help="merge multiple session maps")
    m.add_argument("maps", nargs="+")
    m.add_argument("-o", "--output", required=True)

    s = add("serve", cmd_serve, help="HTTP localization server")
    s.add_argument("--map", action="append", required=True, help="id=path")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--batch-window-ms", type=float, default=5.0)
    s.add_argument("--max-batch", type=int, default=32)
    s.add_argument("--shards", type=int, default=1,
                   help="split each map into N shards, one per device (round-robin "
                        "over the visible cards), each query routed by retrieval")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip the batch-bucket warm-up at startup")
    s.add_argument("--config", default=None)
    s.add_argument("--override", "-D", action="append")

    g = add("georeference", cmd_georeference, help="align map to world control points")
    g.add_argument("map")
    g.add_argument("control", help="JSON [[cam_idx,wx,wy,wz],...]")
    g.add_argument("-o", "--output", default=None)

    e = add("evaluate", cmd_evaluate, help="map stats + trajectory ATE")
    e.add_argument("map")
    e.add_argument("--reference", default=None, help="txt file of (C,3) true centers")

    x = add("export", cmd_export, help="export map to PLY (cloud + frusta)")
    x.add_argument("map")
    x.add_argument("-o", "--output", default=None)
    x.add_argument("--frustum-scale", type=float, default=0.15)

    add("bench", cmd_bench, help="run the benchmark (bench.py's metrics) on the device")

    bd = add("bundle", cmd_bundle, help="package the map artifacts for deployment",
             description="Package the map artifacts (store, .lmap, .feats.npz). "
                         "No compile cache: the reference's --cache/--no-cache ship "
                         "XLA's compile cache, which the port does not have.")
    bd.add_argument("map", help="map path (as given to build-map -o)")
    bd.add_argument("-o", "--output", required=True, help="bundle .tar.gz")

    ub = add("unbundle", cmd_unbundle, help="extract a deploy bundle")
    ub.add_argument("bundle")
    ub.add_argument("-d", "--dest", required=True)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
