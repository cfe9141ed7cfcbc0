"""Typed config tree, overridable from key=value pairs and YAML
(port of ``sfmx.cli.config``, same defaults)."""
from __future__ import annotations

import dataclasses
from pathlib import Path

from ..recon.incremental import ReconConfig


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    extractor: str = "akaze"  # akaze (nonlinear scale space) | sift (not ported)
    max_keypoints: int = 1024
    threshold: float = 1e-7   # det-Hessian threshold
    sigma_levels: tuple = (2, 3, 4, 5, 6)
    oriented: bool = False    # upright default (gravity-aligned indoor rigs)
    n_octaves: int = 2        # 2x-downsampled octaves widen the scale band


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    ratio: float = 0.85
    cross_check: bool = True
    pair_mode: str = "exhaustive"   # exhaustive | window | retrieval
    window: int = 8
    retrieval_k: int = 8
    geometric_verify: bool = True
    gv_px_thresh: float = 4.0
    gv_hypotheses: int = 256
    gv_min_inliers: int = 16
    binary: bool = False
    kernel: str = "auto"


@dataclasses.dataclass(frozen=True)
class LocalizeConfig:
    top_k_kf: int = 8
    m_cap: int = 2048
    k_hypotheses: int = 1024
    px_thresh: float = 4.0
    sim_thresh: float = 0.75
    min_inliers: int = 12
    binary: bool = False        # Hamming 2D-3D matching (gather path)
    ham_thresh: float = 120.0
    pnp_solver: str = "dlt6"    # dlt6 | p3p
    streaming: str = "auto"     # off | on | auto (map-size gated, kernel K4)
    streaming_min_landmarks: int = 65536


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    features: FeatureConfig = FeatureConfig()
    match: MatchConfig = MatchConfig()
    recon: ReconConfig = ReconConfig()
    localize: LocalizeConfig = LocalizeConfig()
    resize_to: tuple | None = (640, 480)
    focal_factor: float = 1.2


def _set_path(cfg, dotted: str, value: str):
    """Immutable update of cfg.<a.b.c> from a string value."""
    parts = dotted.split(".")
    if len(parts) == 1:
        field = parts[0]
        cur = getattr(cfg, field)
        return dataclasses.replace(cfg, **{field: _coerce(cur, value)})
    sub = getattr(cfg, parts[0])
    return dataclasses.replace(cfg, **{parts[0]: _set_path(sub, ".".join(parts[1:]), value)})


def _coerce(cur, value: str):
    if isinstance(cur, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(value)
    if isinstance(cur, float):
        return float(value)
    if isinstance(cur, tuple) or (cur is None and "," in value):
        def conv(v):
            v = v.strip()
            if v.isdigit():
                return int(v)
            try:
                return float(v)
            except ValueError:
                return v
        return tuple(conv(v) for v in value.split(","))
    return value


def load_config(yaml_path: str | None = None, overrides: list[str] = ()) -> PipelineConfig:
    cfg = PipelineConfig()
    if yaml_path:
        import yaml

        data = yaml.safe_load(Path(yaml_path).read_text()) or {}

        def apply(cfg, prefix, d):
            for k, v in d.items():
                if isinstance(v, dict):
                    cfg = apply(cfg, f"{prefix}{k}.", v)
                else:
                    cfg = _set_path(cfg, f"{prefix}{k}", str(v))
            return cfg

        cfg = apply(cfg, "", data)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        cfg = _set_path(cfg, k, v)
    return cfg
