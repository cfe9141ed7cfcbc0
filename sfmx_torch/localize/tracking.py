"""Sequential localization: per-frame tracking with a temporal pose prior
(port of ``sfmx.localize.tracking``).

Each accepted pose's center gates the next frame's retrieval (the same hook
as a beacon prior: ``prior_center``/``prior_radius``); a frame the prior-gated
search does not accept falls back to global relocalization, and a track that
coasts for more than ``max_coast`` frames stops trusting its stale prior.
The reference runs the whole sequence as one ``lax.scan``; its own tests
show that the scan and the host stepper are the same function, so here
``localize_sequence`` is the host loop over ``SequenceLocalizer.step``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..solvers.ransac import gumbel_noise
from .localize import LocalizationMap, LocalizeResult, localize_query


@dataclass
class TrackingConfig:
    radius: float = 3.0          # map-units search radius around the prior
    min_conf: float = 0.05       # below this the frame does not update the prior
    min_inliers: int = 12        # accept gate (shared with LocalizeConfig)
    max_coast: int = 3           # tracked frames allowed without an accept
    # localize_query passthrough:
    top_k_kf: int = 8
    m_cap: int = 2048
    k_hypotheses: int = 1024
    px_thresh: float = 4.0
    sim_thresh: float = 0.75
    pnp_solver: str = "dlt6"
    extra: dict = field(default_factory=dict)  # more localize_query keywords


@dataclass
class TrackingState:
    """Host-side inter-frame state."""

    center: np.ndarray | None = None
    tracked: bool = False
    coast: int = 0               # consecutive low-confidence frames


class SequenceLocalizer:
    """Frame-by-frame localization against one map with track/reloc logic::

        seq = SequenceLocalizer(lmap, intr, TrackingConfig(radius=2.0))
        for desc, uv, mask in stream:
            res, tracked = seq.step(desc, uv, mask, generator=gen)
    """

    def __init__(self, lmap: LocalizationMap, intr: torch.Tensor,
                 cfg: TrackingConfig | None = None):
        self.lmap = lmap
        self.intr = torch.as_tensor(intr, dtype=torch.float32, device=lmap.X.device)
        self.cfg = cfg or TrackingConfig()
        self.state = TrackingState()
        self.stats = {"frames": 0, "tracked": 0, "relocalized": 0, "lost": 0}

    def _kw(self):
        c = self.cfg
        return dict(top_k_kf=c.top_k_kf, m_cap=c.m_cap,
                    k_hypotheses=c.k_hypotheses, px_thresh=c.px_thresh,
                    sim_thresh=c.sim_thresh, min_inliers=c.min_inliers,
                    pnp_solver=c.pnp_solver, **c.extra)

    def step(self, q_desc, q_uv, q_mask, *, gumbel: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> tuple[LocalizeResult, bool]:
        """Localize one frame.  Returns (result, tracked_flag): True when the
        accepted pose came from the prior-gated search, False for global
        (re)localization.  ``gumbel`` (k_hyp,K) is the frame's RANSAC noise,
        used by both searches; when None it is drawn once from ``generator``.
        """
        c, st = self.cfg, self.state
        self.stats["frames"] += 1
        if gumbel is None:
            gumbel = gumbel_noise((c.k_hypotheses, q_desc.shape[0]), device=q_desc.device,
                                  generator=generator)
        kw = dict(self._kw(), gumbel=gumbel)
        res, via_prior = None, False
        if st.tracked and st.center is not None:
            res = localize_query(
                self.lmap, q_desc, q_uv, q_mask, self.intr,
                prior_center=torch.as_tensor(st.center, dtype=torch.float32,
                                             device=self.intr.device),
                prior_radius=c.radius, **kw)
            # only an ACCEPTED prior-gated pose counts as tracking; a weak
            # result falls through to the global search
            via_prior = float(res.confidence) >= c.min_conf
        if res is None or not via_prior:
            res = localize_query(self.lmap, q_desc, q_uv, q_mask, self.intr, **kw)

        accepted = float(res.confidence) >= c.min_conf
        if accepted:
            st.center = res.center.detach().cpu().numpy()
            st.coast = 0
            st.tracked = True
            self.stats["tracked" if via_prior else "relocalized"] += 1
        else:
            st.coast += 1
            self.stats["lost"] += 1
            if st.coast > c.max_coast:
                st.tracked = False  # stop trusting the stale prior
        return res, via_prior and accepted


def localize_sequence(lmap: LocalizationMap, q_desc, q_uv, q_mask, intr,
                      cfg: TrackingConfig | None = None, *,
                      gumbel: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
    """Localize a whole (N,K,...) feature sequence with temporal tracking.

    ``gumbel`` (N,k_hyp,K) holds each frame's RANSAC noise (otherwise drawn
    from ``generator``).  Returns (list[LocalizeResult], list[bool] tracked
    flags, stats dict).
    """
    seq = SequenceLocalizer(lmap, intr, cfg)
    results, flags = [], []
    for i in range(q_desc.shape[0]):
        r, f = seq.step(q_desc[i], q_uv[i], q_mask[i],
                        gumbel=None if gumbel is None else gumbel[i], generator=generator)
        results.append(r)
        flags.append(f)
    return results, flags, dict(seq.stats)
