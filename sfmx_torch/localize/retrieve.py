"""Image retrieval: k-means vocabulary + VLAD global descriptors, and the
retrieval-quality metrics (port of ``sfmx.localize.retrieve``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def build_vocabulary(desc: torch.Tensor, mask: torch.Tensor, first: int, *,
                     n_words: int = 16, iters: int = 15) -> torch.Tensor:
    """Cosine k-means over unit descriptors. desc (N,D), mask (N,).

    ``first`` is the index of the first seed word (the reference draws it
    with ``jax.random.choice``); the rest are farthest-point seeded, then
    ``iters`` Lloyd steps.  Returns (n_words, D) unit-norm centroids.
    """
    N, D = desc.shape
    C = torch.zeros((n_words, D), dtype=desc.dtype, device=desc.device)
    C[0] = desc[first]
    col = torch.arange(n_words, device=desc.device)
    inf = torch.tensor(torch.inf, dtype=desc.dtype, device=desc.device)
    for i in range(1, n_words):
        sim = desc @ C.T                                        # (N,V)
        best = torch.max(torch.where(col[None, :] < i, sim, -inf), dim=1).values
        cand = torch.argmin(torch.where(mask, best, inf))
        C[i] = desc[cand]
    m = mask.to(desc.dtype)[:, None]
    for _ in range(iters):
        a = torch.argmax(desc @ C.T, dim=1)
        onehot = F.one_hot(a, n_words).to(desc.dtype) * m
        sums = onehot.T @ desc                                  # (V,D)
        counts = torch.sum(onehot, dim=0)[:, None]
        C2 = torch.where(counts > 0, sums / torch.clamp(counts, min=1), C)
        C = C2 / torch.clamp(torch.linalg.vector_norm(C2, dim=1, keepdim=True), min=1e-8)
    return C


def vlad_encode(desc: torch.Tensor, mask: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """VLAD: per-word residual sums, intra-normalized, then L2-normalized.

    desc (...,K,D), mask (...,K), vocab (V,D) -> (...,V*D); leading axes
    are batch axes (the reference's ``vlad_encode_b``).
    """
    V, D = vocab.shape
    a = torch.argmax(desc @ vocab.T, dim=-1)                    # (...,K)
    onehot = F.one_hot(a, V).to(desc.dtype) * mask[..., None].to(desc.dtype)
    sums = onehot.transpose(-1, -2) @ desc                      # (...,V,D)
    counts = torch.sum(onehot, dim=-2)[..., None]               # (...,V,1)
    resid = sums - counts * vocab
    resid = resid / torch.clamp(torch.linalg.vector_norm(resid, dim=-1, keepdim=True), min=1e-8)
    v = resid.reshape(*resid.shape[:-2], V * D)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)


def retrieval_scores(kf_vlad: torch.Tensor, q_vlad: torch.Tensor) -> torch.Tensor:
    """(C,VD) x (VD,) -> (C,) cosine scores (one GEMV)."""
    return kf_vlad @ q_vlad


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scores_and_distances(kf_gdesc, kf_centers, kf_alive, q_gdesc, q_centers):
    """Host (Q,C) retrieval scores and query-to-keyframe distances, dead
    keyframes at -inf and inf."""
    alive = _host(kf_alive).astype(bool)
    kfc, qc = _host(kf_centers), _host(q_centers)
    scores = _host(q_gdesc) @ _host(kf_gdesc).T
    scores[:, ~alive] = -np.inf
    d = np.sqrt(np.sum((qc[:, None] - kfc[None]) ** 2, -1))
    d[:, ~alive] = np.inf
    return scores, d, alive, kfc


def recall_at_k(kf_gdesc, kf_centers, kf_alive, q_gdesc, q_centers, k: int = 8,
                radius: float | None = None) -> float:
    """Retrieval quality: fraction of queries for which the top-k retrieval
    surfaces a keyframe whose center lies within ``radius`` of the query's
    true position.  None sizes the radius per query to max(3x the nearest
    keyframe's distance, 4x the median keyframe spacing): on densely sampled
    walks many keyframes see the same spot, and any of them serves 2D-3D
    matching.  Host numpy; tensors on any device or arrays."""
    scores, d, alive, kfc = _scores_and_distances(kf_gdesc, kf_centers, kf_alive, q_gdesc,
                                                  q_centers)
    if radius is None:
        ai = np.flatnonzero(alive)
        if len(ai) > 4096:  # spacing estimate from a subsample (O(n^2) memory)
            ai = ai[:: len(ai) // 4096 + 1]
        if len(ai) > 1:
            kd = np.sqrt(np.sum((kfc[ai][:, None] - kfc[ai][None]) ** 2, -1))
            np.fill_diagonal(kd, np.inf)
            spacing = float(np.median(kd.min(axis=1)))
        else:
            spacing = 0.0
        radius = np.maximum(3.0 * d.min(axis=1), 4.0 * spacing)  # (Q,)
    kk = min(k, int(alive.sum()))
    topk = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
    d_top = np.take_along_axis(d, topk, axis=1)          # (Q,kk)
    hit = (d_top <= np.asarray(radius).reshape(-1, 1)
           if np.ndim(radius) else d_top <= radius).any(axis=1)
    return float(hit.mean())


def strict_recall_at_k(kf_gdesc, kf_centers, kf_alive, q_gdesc, q_centers,
                       k: int = 8) -> float:
    """Strict recall: fraction of queries whose single spatially nearest
    alive keyframe appears in the retrieval top-k (near chance on densely
    sampled walks by construction; telling on visually diverse maps)."""
    scores, d, alive, _ = _scores_and_distances(kf_gdesc, kf_centers, kf_alive, q_gdesc,
                                                q_centers)
    nearest = d.argmin(axis=1)                           # (Q,)
    kk = min(k, int(alive.sum()))
    topk = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
    return float((topk == nearest[:, None]).any(axis=1).mean())
