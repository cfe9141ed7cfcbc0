"""Batch query localization (port of ``sfmx.cli.main``'s ``localize`` body).

``localize_images`` is the non-sequential branch of ``cmd_localize``:
extract every image, then localize fixed 16-frame chunks (the last one
padded by repeating its final image) on the gather path.  The argparse
front end and image ingest are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..localize.localize import LocalizationMap, localize_batch, use_streaming
from .config import PipelineConfig
from .pipeline import extract_features

CHUNK = 16


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
    if lc.binary:
        raise NotImplementedError("binary (Hamming) 2D-3D matching is not ported")
    if use_streaming(lc, lmap, binary=False):
        raise NotImplementedError("streaming path needs K4")
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
        res = localize_batch(
            lmap, feats.desc[pad], feats.kp.uv[pad], feats.kp.mask[pad], intr0,
            generator=generator, gumbel=None if gumbel is None else gumbel[c],
            top_k_kf=lc.top_k_kf, m_cap=lc.m_cap, k_hypotheses=lc.k_hypotheses,
            px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
            min_inliers=lc.min_inliers, pnp_solver=lc.pnp_solver)
        R, t, n_inl, conf, center = (x.cpu().numpy() for x in res)
        out.extend({"R": R[i].tolist(), "t": t[i].tolist(), "center": center[i].tolist(),
                    "n_inliers": int(n_inl[i]), "confidence": float(conf[i])}
                   for i in range(len(idx)))
    return out
