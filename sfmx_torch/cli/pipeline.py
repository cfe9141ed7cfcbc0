"""Extraction dispatch of the batch pipeline (port of the extraction part
of ``sfmx.cli.pipeline``).  Only the AKAZE-analog extractor is ported."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import features
from .config import PipelineConfig


def _extract_raw(images, cfg: PipelineConfig, device) -> features.Features:
    """Extractor dispatch without any host sync: (N,H,W) images in [0,1],
    a numpy array or a tensor."""
    if cfg.features.extractor != "akaze":
        raise NotImplementedError(f"extractor={cfg.features.extractor!r}: "
                                  "only akaze is ported")
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    sscfg = features.ScaleSpaceConfig(sigma_levels=tuple(cfg.features.sigma_levels))
    return features.detect_and_describe(
        images.to(device=device, dtype=torch.float32), sscfg,
        max_keypoints=cfg.features.max_keypoints,
        threshold=cfg.features.threshold,
        oriented=cfg.features.oriented,
        n_octaves=cfg.features.n_octaves,
    )


# The reference's extract_features adds only a log scope around _extract_raw.
extract_features = _extract_raw
