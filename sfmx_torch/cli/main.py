"""Command bodies of the pipeline (port of ``sfmx.cli.main``'s ``localize``
and ``serve``), as functions; the argparse front end and image ingest are
not ported yet.

- ``localize_images``: the batch branch of ``cmd_localize``: extract every
  image, then localize fixed 16-frame chunks (the last one padded by
  repeating its final image) on the streaming path (kernel K4) where
  ``use_streaming`` says so, else on the gather path (Hamming matching for
  binary maps);
- ``localize_sequence_images``: its ``--sequential`` branch (tracking);
- ``load_lmap``: a scene store and its serving map;
- ``make_service``/``serve``: the body of ``cmd_serve``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..localize.localize import (LocalizationMap, build_localization_map,
                                 localize_batch, localize_batch_streaming, use_streaming)
from ..mapstore.lmap_store import has_localization_map, load_localization_map
from ..mapstore.scene import load_scene_np
from .config import PipelineConfig
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
    """Serve the maps over HTTP until interrupted (``sfmx serve``)."""
    from aiohttp import web

    from ..serve import make_app

    service = make_service(map_specs, cfg, device, batch_window_ms=batch_window_ms,
                           max_batch=max_batch, shards=shards, warmup=warmup)
    web.run_app(make_app(service), port=port)
