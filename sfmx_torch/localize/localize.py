"""Visual localization: retrieval -> 2D-3D matching -> PnP-RANSAC
(port of ``sfmx.localize.localize``, gather path).

The whole query path runs on static capacities with the query batch as a
leading axis: VLAD retrieval GEMM, top-k keyframes, candidate-landmark
gather, (K x M) descriptor GEMM with mutual-best + absolute threshold,
batched PnP-RANSAC over all hypotheses of all queries, GN refine.  These
GEMMs and gathers are plain torch, as they were plain XLA ops in ``sfmx``.
The streaming path (full-pool matching on kernel K4) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import cameras
from ..core.masking import NEG_INF, topk_lowest_index
from ..solvers import pnp, ransac
from . import retrieve


class LocalizationMap(NamedTuple):
    """Device-resident map for serving. P landmarks, C keyframes, D desc dim."""

    X: torch.Tensor           # (P,3) landmark positions
    lm_desc: torch.Tensor     # (P,D) mean landmark descriptor (unit norm)
    lm_alive: torch.Tensor    # (P,) bool
    kf_gdesc: torch.Tensor    # (C,G) keyframe global descriptor (VLAD or mean)
    kf_alive: torch.Tensor    # (C,) bool
    kf_centers: torch.Tensor  # (C,3) keyframe camera centers
    kf_lm: torch.Tensor       # (C,Kc) int64 landmark ids per keyframe
    kf_lm_mask: torch.Tensor  # (C,Kc) bool
    vocab: torch.Tensor | None = None    # (V,D) VLAD vocabulary; None = mean pooling
    lm_bits: torch.Tensor | None = None  # (P,W) int32 (uint32 bit patterns)

    @classmethod
    def from_numpy(cls, cols: dict, device) -> "LocalizationMap":
        """Build from numpy columns (the ``sfmx`` map's fields as numpy, or a
        loaded store); uint32 bits become int32 with the same bit patterns."""
        def put(k):
            v = cols.get(k)
            if v is None:
                return None
            v = np.asarray(v)
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            if k == "kf_lm":
                v = v.astype(np.int64)
            return torch.from_numpy(np.array(v)).to(device)

        return cls(**{k: put(k) for k in cls._fields})

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Columns in the store's dtypes (kf_lm int32, lm_bits uint32)."""
        cols = {}
        for k in self._fields:
            v = getattr(self, k)
            if v is None:
                continue
            a = v.detach().cpu().numpy()
            if k == "kf_lm":
                a = a.astype(np.int32)
            elif k == "lm_bits":
                a = a.view(np.uint32)
            cols[k] = a
        return cols


class LocalizeResult(NamedTuple):
    R: torch.Tensor           # (...,3,3) world->cam
    t: torch.Tensor           # (...,3)
    n_inliers: torch.Tensor   # (...) int32
    confidence: torch.Tensor  # (...) float in [0,1]
    center: torch.Tensor      # (...,3) camera center in world frame


def build_localization_map(scene, feat_desc: np.ndarray, obs_feat: np.ndarray,
                           device, kf_lm_cap: int = 512,
                           kp_mask: np.ndarray | None = None,
                           use_vlad: bool = True, n_words: int = 64,
                           seed: int = 0, vocab_first: int | None = None) -> LocalizationMap:
    """Aggregate per-feature descriptors into the serving map (once).

    scene: mapping of numpy scene columns (``obs_cam``, ``obs_pt``,
      ``obs_alive``, ``X``, ``X_alive``, ``cam_R``, ``cam_t``,
      ``cam_alive``), e.g. a loaded scene store.
    feat_desc: (C,K,D) float descriptors of every keyframe feature.
    obs_feat: (O,) feature index of each scene observation.
    vocab_first: index (into the observed landmarks) of the first k-means
      seed word; drawn from a generator seeded with ``seed`` when None.
    The map has no ``lm_bits`` column: binary matching is not ported yet.
    """
    obs_cam = np.asarray(scene["obs_cam"])
    obs_pt = np.asarray(scene["obs_pt"])
    obs_alive = np.asarray(scene["obs_alive"]).astype(bool)
    X = np.asarray(scene["X"], np.float32)
    P = X.shape[0]
    C, K, D = feat_desc.shape

    lm_desc = np.zeros((P, D), np.float32)
    cnt = np.zeros(P, np.float32)
    d = feat_desc[obs_cam[obs_alive], obs_feat[obs_alive]]
    np.add.at(lm_desc, obs_pt[obs_alive], d)
    np.add.at(cnt, obs_pt[obs_alive], 1.0)
    lm_desc /= np.maximum(cnt[:, None], 1.0)
    lm_desc /= np.maximum(np.linalg.norm(lm_desc, axis=1, keepdims=True), 1e-8)

    if kp_mask is None:
        kp_mask = np.linalg.norm(feat_desc, axis=-1) > 1e-6
    vocab = None
    if use_vlad:
        valid = lm_desc[cnt > 0]
        if len(valid) >= n_words:
            if vocab_first is None:
                gen = torch.Generator().manual_seed(seed)
                vocab_first = int(torch.randint(len(valid), (1,), generator=gen))
            vt = torch.from_numpy(valid).to(device)
            vocab = retrieve.build_vocabulary(
                vt, torch.ones(len(valid), dtype=torch.bool, device=device),
                vocab_first, n_words=n_words)
            kf_gdesc = retrieve.vlad_encode(
                torch.from_numpy(np.ascontiguousarray(feat_desc)).to(device),
                torch.from_numpy(np.ascontiguousarray(kp_mask)).to(device), vocab)
        else:
            use_vlad = False
    if not use_vlad:
        g = feat_desc.mean(axis=1)
        g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-8)
        kf_gdesc = torch.from_numpy(g.astype(np.float32)).to(device)

    kf_lm = np.zeros((C, kf_lm_cap), np.int32)
    kf_lm_mask = np.zeros((C, kf_lm_cap), bool)
    for c in range(C):
        ids = np.unique(obs_pt[(obs_cam == c) & obs_alive])
        if len(ids) > kf_lm_cap:
            # keep the most-observed landmarks (strongest tracks)
            ids = ids[np.argsort(-cnt[ids], kind="stable")[:kf_lm_cap]]
        kf_lm[c, :len(ids)] = ids
        kf_lm_mask[c, :len(ids)] = True

    cam_R = np.asarray(scene["cam_R"], np.float32)
    cam_t = np.asarray(scene["cam_t"], np.float32)
    cols = {
        "X": X, "lm_desc": lm_desc, "lm_alive": np.asarray(scene["X_alive"]),
        "kf_alive": np.asarray(scene["cam_alive"]),
        "kf_centers": -np.einsum("cji,cj->ci", cam_R, cam_t).astype(np.float32),
        "kf_lm": kf_lm, "kf_lm_mask": kf_lm_mask,
    }
    lmap = LocalizationMap.from_numpy(cols, device)
    return lmap._replace(kf_gdesc=kf_gdesc, vocab=vocab)


def _pnp_from_matches(xn, X3, corr_ok, intr, gumbel, *, px_thresh: float,
                      min_inliers: int) -> LocalizeResult:
    """Shared PnP-RANSAC (6-point DLT) + GN tail for a batch of queries.

    xn (B,K,2), X3 (B,K,3), corr_ok (B,K), intr (7,), gumbel (B,k_hyp,K).
    """
    f_mean = 0.5 * (intr[0] + intr[1])
    thresh_n = (px_thresh / f_mean) ** 2

    def residual_fn(model, xn_d, X_d):
        R, t = model
        r = pnp.pnp_residual(R, t, xn_d, X_d)
        return torch.sum(r * r, dim=-1)

    (R, t), inliers, _ = ransac.ransac(
        gumbel, pnp.dlt_pnp_minimal, residual_fn, (xn, X3), corr_ok,
        sample_size=pnp.MIN_SAMPLE, inlier_threshold=thresh_n)
    R, t = pnp.refine_pnp_gn(R, t, xn, X3, inliers)
    r = residual_fn((R, t), xn, X3)
    inliers = (r < thresh_n) & corr_ok
    n_inl = torch.sum(inliers, dim=-1, dtype=torch.int32)
    n_corr = torch.clamp(torch.sum(corr_ok, dim=-1, dtype=torch.int32), min=1)
    conf = torch.where(n_inl >= min_inliers,
                       torch.clamp(n_inl.to(torch.float32) / n_corr.to(torch.float32), 0.0, 1.0),
                       torch.zeros_like(n_inl, dtype=torch.float32))
    center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return LocalizeResult(R=R, t=t, n_inliers=n_inl, confidence=conf, center=center)


def localize_batch(lmap: LocalizationMap, q_desc: torch.Tensor, q_uv: torch.Tensor,
                   q_mask: torch.Tensor, intr: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None,
                   top_k_kf: int = 8, m_cap: int = 2048, k_hypotheses: int = 1024,
                   px_thresh: float = 4.0, sim_thresh: float = 0.75,
                   min_inliers: int = 12, prior_center: torch.Tensor | None = None,
                   prior_radius: float = 0.0, pnp_solver: str = "dlt6") -> LocalizeResult:
    """Localize a batch of queries against the map (gather path).

    q_desc (B,K,D) unit descriptors, q_uv (B,K,2) pixels, q_mask (B,K),
    intr (7,) shared intrinsics.  ``gumbel`` (B,k_hypotheses,K) is the
    RANSAC sampling noise; when None it is drawn from ``generator``.
    prior_center/prior_radius gate retrieval to keyframes near a prior.
    """
    if pnp_solver != "dlt6":
        raise NotImplementedError(f"pnp_solver={pnp_solver!r}: only dlt6 is ported")
    B, K, D = q_desc.shape
    dev = q_desc.device
    # --- retrieval: VLAD (or mean) global scores, optional beacon gate
    if lmap.vocab is not None:
        qg = retrieve.vlad_encode(q_desc, q_mask, lmap.vocab)
    else:
        qg = torch.sum(torch.where(q_mask[..., None], q_desc, torch.zeros_like(q_desc)), dim=1)
        qg = qg / torch.clamp(torch.linalg.vector_norm(qg, dim=-1, keepdim=True), min=1e-8)
    scores = qg @ lmap.kf_gdesc.T                                  # (B,C)
    gate = lmap.kf_alive[None, :]
    if prior_center is not None:
        d2 = torch.sum((lmap.kf_centers - prior_center) ** 2, dim=-1)
        gate = gate & (d2 <= prior_radius * prior_radius)
    scores = torch.where(gate, scores, torch.full_like(scores, NEG_INF))
    kf_vals, kf_idx = topk_lowest_index(scores, min(top_k_kf, scores.shape[-1]))
    kf_ok = kf_vals > NEG_INF / 2

    # --- candidate landmark set (gather; duplicates tolerated)
    cand = lmap.kf_lm[kf_idx].reshape(B, -1)[:, :m_cap]            # (B,M)
    cand_mask = (lmap.kf_lm_mask[kf_idx] & kf_ok[..., None]).reshape(B, -1)[:, :m_cap]
    cand_mask = cand_mask & lmap.lm_alive[cand]
    cdesc = lmap.lm_desc[cand]                                     # (B,M,D)
    cX = lmap.X[cand]                                              # (B,M,3)

    # --- 2D-3D matching: absolute threshold + mutual best
    sim = q_desc @ cdesc.transpose(-1, -2)                         # (B,K,M)
    sim = torch.where(q_mask[:, :, None] & cand_mask[:, None, :], sim,
                      torch.full_like(sim, NEG_INF))
    best_m = torch.argmax(sim, dim=2)                              # (B,K)
    best_s = torch.amax(sim, dim=2)
    back = torch.argmax(sim, dim=1)                                # (B,M)
    mutual = torch.gather(back, 1, best_m) == torch.arange(K, device=dev)[None, :]
    corr_ok = (best_s > sim_thresh) & mutual & q_mask

    xn = cameras.pixel_to_normalized(intr, q_uv)                   # (B,K,2)
    X3 = torch.gather(cX, 1, best_m[..., None].expand(B, K, 3))    # (B,K,3)
    if gumbel is None:
        gumbel = ransac.gumbel_noise((B, k_hypotheses, K), device=dev, generator=generator)
    elif tuple(gumbel.shape) != (B, k_hypotheses, K):
        raise ValueError(f"gumbel must be {(B, k_hypotheses, K)}, got {tuple(gumbel.shape)}")
    return _pnp_from_matches(xn, X3, corr_ok, intr, gumbel,
                             px_thresh=px_thresh, min_inliers=min_inliers)


def localize_query(lmap: LocalizationMap, q_desc, q_uv, q_mask, intr, *,
                   gumbel: torch.Tensor | None = None, **kw) -> LocalizeResult:
    """Localize one query (K,D)/(K,2)/(K,); ``gumbel`` is (k_hyp,K)."""
    res = localize_batch(lmap, q_desc[None], q_uv[None], q_mask[None], intr,
                         gumbel=None if gumbel is None else gumbel[None], **kw)
    return LocalizeResult(*(x[0] for x in res))


def use_streaming(lc, lmap: LocalizationMap, binary: bool) -> bool:
    """Policy for LocalizeConfig.streaming: off | on | auto (map-size gated).
    Binary maps keep the gather path."""
    if binary or lc.streaming == "off":
        return False
    if lc.streaming == "on":
        return True
    return lc.streaming == "auto" and lmap.X.shape[0] >= lc.streaming_min_landmarks
