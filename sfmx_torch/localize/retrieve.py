"""Image retrieval: k-means vocabulary + VLAD global descriptors
(port of ``sfmx.localize.retrieve``)."""
from __future__ import annotations

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
