"""Beacon/image fusion (port of ``sfmx.localize.fusion``): a BLE position
prior arbitrates and blends the vision pose.

The beacon side itself lives in a beacon engine; this module consumes a
prior estimate (position + uncertainty radius + confidence).  As in the
reference's server, ``serve.server`` uses the prior only here, in ``fuse``,
and not as a retrieval gate.  Every field may carry a leading batch axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .localize import LocalizeResult


class BeaconPrior(NamedTuple):
    center: torch.Tensor               # (...,3) world position estimate
    radius: float | torch.Tensor       # gating radius (uncertainty, meters)
    confidence: float | torch.Tensor   # 0..1


class FusedResult(NamedTuple):
    center: torch.Tensor      # (...,3) fused position
    R: torch.Tensor           # (...,3,3) orientation (vision's; beacons carry none)
    confidence: torch.Tensor  # (...)
    source: torch.Tensor      # (...) int32: 0=vision, 1=beacon, 2=blend


def fuse(vision: LocalizeResult, prior: BeaconPrior | None, *,
         min_vision_conf: float = 0.05) -> FusedResult:
    """Arbitrate/blend the vision pose with the beacon prior.

    - no prior -> vision as-is;
    - vision confident -> confidence-weighted blend of the centers, the
      beacon weighted by half its confidence so it never dominates;
    - vision failed (conf < min_vision_conf) -> the beacon center and the
      beacon's confidence.
    """
    if prior is None:
        return FusedResult(vision.center, vision.R, vision.confidence,
                           torch.zeros_like(vision.confidence, dtype=torch.int32))
    dev = vision.confidence.device
    v_ok = vision.confidence >= min_vision_conf
    b_conf = torch.as_tensor(prior.confidence, dtype=torch.float32, device=dev)
    b_center = torch.as_tensor(prior.center, dtype=torch.float32, device=dev)
    wv = torch.where(v_ok, vision.confidence, torch.zeros_like(vision.confidence))
    wb = b_conf * 0.5
    denom = torch.clamp(wv + wb, min=1e-6)
    blend = (wv[..., None] * vision.center + wb[..., None] * b_center) / denom[..., None]
    center = torch.where(v_ok[..., None], blend, b_center.expand_as(blend))
    conf = torch.where(v_ok, torch.maximum(vision.confidence, b_conf), b_conf)
    source = torch.where(v_ok, torch.where(wb > 0, 2, 0), 1).to(torch.int32)
    return FusedResult(center, vision.R, conf, source)
