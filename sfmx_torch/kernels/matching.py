"""Descriptor matching: GEMM / Hamming brute force + Lowe ratio + cross-check
(port of ``sfmx.kernels.matching``).

A match of image A against B scores the (Ka,Kb) similarity matrix (bf16
inputs, f32 products, as the reference's MXU GEMM) or the Hamming distances
of packed binary words, then keeps each A row's best B column when it passes
the ratio test and, with ``cross_check``, is the column's best row too.
``match_pairs_float`` is the dense oracle over a pair list and the plain
version of the kernels K5/K9 (``pairs.py``, ``tiles.py``);
``match_pairs_float_auto`` is the production dispatch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.masking import NEG_INF, topk_lowest_index

# (pairs x K x K) similarity elements one chunk of the plain matchers may
# hold: the reference's vmap makes the whole (Np,K,K) tensor, 19 GB at
# 4,560 pairs x 1024^2
CHUNK_ELEMS = 1 << 26


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (...,Ka) int64 best match index into B
    valid: torch.Tensor  # (...,Ka) bool passed ratio + cross-check + masks
    score: torch.Tensor  # (...,Ka) similarity of the best match

    @classmethod
    def from_numpy(cls, m, device) -> "MatchResult":
        """From any record with ``idx``/``valid``/``score`` array-likes (the
        reference's MatchResult included), onto ``device``."""
        def t(x, dtype):  # a copy: the reference's arrays are read-only
            return torch.as_tensor(np.array(x), device=device).to(dtype)

        return cls(idx=t(m.idx, torch.int64), valid=t(m.valid, torch.bool),
                   score=t(m.score, torch.float32))

    def to_numpy(self) -> "MatchResult":
        """The same record with numpy fields (idx int32, as the reference's)."""
        return MatchResult(idx=self.idx.cpu().numpy().astype(np.int32),
                           valid=self.valid.cpu().numpy(),
                           score=self.score.cpu().numpy())


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word read as uint32 (torch has no popcount):
    the SWAR bit trick, in int64 so no step overflows.  Returns int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(...,Ka,W) x (...,Kb,W) int32 words (uint32 bit patterns) ->
    (...,Ka,Kb) int32 Hamming distances.  One word at a time, so only one
    (...,Ka,Kb) temporary lives per step."""
    out = None
    for w in range(bits_a.shape[-1]):
        c = popcount32(bits_a[..., :, None, w] ^ bits_b[..., None, :, w])
        out = c if out is None else out + c
    return out.to(torch.int32)


def _cross_ok(sim: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """Mutual best: the first row attaining each column's max (``jnp.argmax``
    over axis -2) is the row itself, at its winning column i1."""
    j1 = topk_lowest_index(sim.transpose(-1, -2), 1)[1][..., 0]      # (...,Kb)
    rows = torch.arange(sim.shape[-2], device=sim.device)
    return torch.gather(j1, -1, i1) == rows


def _masked(sim: torch.Tensor, mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    both = mask_a[..., :, None] & mask_b[..., None, :]
    return torch.where(both, sim, torch.full_like(sim, NEG_INF))


def match_similarity(sim: torch.Tensor, mask_a: torch.Tensor, mask_b: torch.Tensor,
                     ratio: float, cross_check: bool = True) -> MatchResult:
    """Ratio + mutual-best filtering of a (...,Ka,Kb) similarity matrix.

    ``ratio`` applies in the distance domain of unit float descriptors:
    d^2 = 2 - 2 s, accept if d1^2 < ratio^2 * d2^2.  Masked rows and
    columns score NEG_INF, so a masked row keeps score NEG_INF, index 0.
    """
    sim = _masked(sim, mask_a, mask_b)
    v, i = topk_lowest_index(sim, 2)
    s1, i1, s2 = v[..., 0], i[..., 0], v[..., 1]
    d1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    ok = (d1 < ratio * ratio * d2) & (s1 > NEG_INF / 2)
    if cross_check:
        ok &= _cross_ok(sim, i1)
    return MatchResult(idx=i1, valid=ok & mask_a, score=s1)


def _bf16_sim(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs through an f32 matmul (TF32 off: the products of
    bf16 values are exact, only the summation order differs from the MXU)."""
    a = desc_a.to(torch.bfloat16).to(torch.float32)
    b = desc_b.to(torch.bfloat16).to(torch.float32)
    return a @ b.transpose(-1, -2)


def match_float(desc_a: torch.Tensor, desc_b: torch.Tensor, mask_a: torch.Tensor,
                mask_b: torch.Tensor, *, ratio: float = 0.8,
                cross_check: bool = True) -> MatchResult:
    """Brute-force match of unit-norm float descriptors (one bf16 GEMM)."""
    return match_similarity(_bf16_sim(desc_a, desc_b), mask_a, mask_b, ratio, cross_check)


def match_hamming(bits_a: torch.Tensor, bits_b: torch.Tensor, mask_a: torch.Tensor,
                  mask_b: torch.Tensor, *, ratio: float = 0.8, n_bits: int = 486,
                  cross_check: bool = True) -> MatchResult:
    """Brute-force Hamming match of packed binary descriptors (int32 words)."""
    sim = _masked(-hamming_distance(bits_a, bits_b).to(torch.float32), mask_a, mask_b)
    v, i = topk_lowest_index(sim, 2)
    s1, i1, s2 = v[..., 0], i[..., 0], v[..., 1]
    d1, d2 = -s1, torch.clamp(-s2, min=1e-6)
    ok = (d1 < ratio * d2) & (s1 > NEG_INF / 2)
    if cross_check:
        ok &= _cross_ok(sim, i1)
    return MatchResult(idx=i1, valid=ok & mask_a, score=s1)


def _over_pair_chunks(one, feats: torch.Tensor, masks: torch.Tensor,
                      pairs: torch.Tensor) -> MatchResult:
    """Apply ``one`` to pair chunks small enough that a chunk's (n,K,K)
    scores stay under CHUNK_ELEMS, and concatenate the results."""
    pairs = torch.as_tensor(pairs, device=feats.device).to(torch.int64)
    K = feats.shape[1]
    step = max(1, CHUNK_ELEMS // (K * K))
    parts = []
    for s in range(0, pairs.shape[0], step):
        a, b = pairs[s:s + step, 0], pairs[s:s + step, 1]
        parts.append(one(feats[a], feats[b], masks[a], masks[b]))
    if not parts:
        e = torch.zeros((0, K), device=feats.device)
        return MatchResult(idx=e.to(torch.int64), valid=e.to(torch.bool), score=e)
    return MatchResult(*(torch.cat(x) for x in zip(*parts)))


def match_pairs_float(descs: torch.Tensor, masks: torch.Tensor, pairs, *,
                      ratio: float = 0.8, cross_check: bool = True) -> MatchResult:
    """Dense matcher over a pair list: descs (C,K,D), masks (C,K), pairs
    (Np,2) -> fields (Np,K).  The plain version of K5 and K9, chunked over
    pairs."""
    return _over_pair_chunks(
        lambda da, db, ma, mb: match_float(da, db, ma, mb, ratio=ratio,
                                           cross_check=cross_check),
        descs, masks, pairs)


def match_pairs_hamming(bits: torch.Tensor, masks: torch.Tensor, pairs, *,
                        ratio: float = 0.8, cross_check: bool = True) -> MatchResult:
    """Batched Hamming matching over a pair list: bits (C,K,W) int32 words.
    Plain torch: the reference computes it outside any Pallas kernel."""
    return _over_pair_chunks(
        lambda ba, bb, ma, mb: match_hamming(ba, bb, ma, mb, ratio=ratio,
                                             cross_check=cross_check),
        bits, masks, pairs)


def match_pairs_float_auto(descs: torch.Tensor, masks: torch.Tensor, pairs, *,
                           ratio: float = 0.8, cross_check: bool = True,
                           kernel: str = "auto") -> MatchResult:
    """Dispatched pairwise matching (the production entry).

    ``"auto"`` and ``"pallas"`` take K5 (``pairs.match_pairs_fused``) for
    every K: on Hopper the (K,K) tile never has to fit a fast memory, so
    the reference's VMEM fence (which sends K = 1024 to the dense matcher on
    a TPU) has no counterpart.  ``"tiles"`` takes K9
    (``tiles.match_pairs_float_tiled``), ``"dense"`` the plain matcher on
    any device.  For CPU tensors the kernel wrappers run their plain
    version; for CUDA tensors they launch the kernel or raise (D > 128).
    """
    if kernel == "dense":
        return match_pairs_float(descs, masks, pairs, ratio=ratio, cross_check=cross_check)
    if kernel == "tiles":
        from .tiles import match_pairs_float_tiled

        return match_pairs_float_tiled(descs, masks, pairs, ratio=ratio,
                                       cross_check=cross_check)
    if kernel in ("auto", "pallas"):
        from .pairs import match_pairs_fused

        return match_pairs_fused(descs, masks, pairs, ratio=ratio, cross_check=cross_check)
    raise ValueError(f"unknown match kernel {kernel!r}")


def geometric_verify_errors(gumbel: torch.Tensor, xn: torch.Tensor, kp_mask: torch.Tensor,
                            pairs, matches: MatchResult, *, threshold: float = 1e-5):
    """The body of ``geometric_verify_pairs``: returns (err (Np,K), the
    squared Sampson error of each match under its pair's kept model, and
    valid (Np,K), the matches that took part).  The inliers are
    ``(err < threshold) & valid``."""
    from ..solvers import epipolar, ransac

    pairs = torch.as_tensor(pairs, device=xn.device).to(torch.int64)
    Np, K = matches.idx.shape
    H = gumbel.shape[1]
    a, b = pairs[:, 0], pairs[:, 1]
    idx = matches.idx.to(torch.int64)
    x1 = xn[a]                                                       # (Np,K,2)
    x2 = torch.gather(xn[b], 1, idx[..., None].expand(Np, K, 2))
    valid = matches.valid & kp_mask[a] & torch.gather(kp_mask[b], 1, idx)

    samp = ransac.sample_minimal(gumbel, valid, 8).reshape(Np, H * 8)  # (Np,H*8)
    x1s = torch.gather(x1, 1, samp[..., None].expand(Np, H * 8, 2)).reshape(Np * H, 8, 2)
    x2s = torch.gather(x2, 1, samp[..., None].expand(Np, H * 8, 2)).reshape(Np * H, 8, 2)
    F = epipolar.eight_point_batch(x1s, x2s, torch.ones(x1s.shape[:2], device=xn.device))
    F = F.reshape(Np, H, 3, 3)
    # score every hypothesis against every correspondence of its pair
    e = epipolar.sampson_error_batch(F, x1[:, None], x2[:, None])     # (Np,H,K)
    cnt_h = torch.sum(((e < threshold) & valid[:, None]).to(torch.int32), dim=-1)
    best = torch.argmax(cnt_h, dim=1)                                 # first max
    Fb = F[torch.arange(Np, device=xn.device), best]
    # the essential structure on the raw winner too: an unconstrained F
    # over-admits matches on low-parallax / planar pairs
    eb = epipolar.sampson_error_batch(epipolar.enforce_essential_batch(Fb), x1, x2)
    inl_b = (eb < threshold) & valid
    # weighted LS refit on the winner's inliers + essential structure
    Er = epipolar.enforce_essential_batch(
        epipolar.eight_point_batch(x1, x2, inl_b.to(x1.dtype)))
    er = epipolar.sampson_error_batch(Er, x1, x2)
    cnt_r = torch.sum(((er < threshold) & valid).to(torch.int32), dim=1)
    cnt_b = torch.sum(inl_b.to(torch.int32), dim=1)
    # keep the refit only where it did not lose inliers
    return torch.where((cnt_r >= cnt_b)[:, None], er, eb), valid


def geometric_verify_pairs(gumbel: torch.Tensor, xn: torch.Tensor, kp_mask: torch.Tensor,
                           pairs, matches: MatchResult, *, threshold: float = 1e-5):
    """Essential-matrix RANSAC filter per pair, batched over all pairs.

    gumbel (Np,H,K) sampling noise (``ransac.gumbel_noise``; H hypotheses),
    xn (C,K,2) normalized coordinates, kp_mask (C,K), pairs (Np,2),
    matches with (Np,K) fields.  Returns (inlier mask (Np,K) bool aligned
    to matches.idx, inlier counts (Np,) int32).  ``threshold`` is the
    squared Sampson error in normalized coordinates (~ (px/f)^2).

    All Np*H minimal 8-point systems solve in one SVD-free batch
    (``epipolar.eight_point_batch``), every hypothesis scores against every
    correspondence of its pair at once, and only the Np winners get the
    essential structure, a weighted least-squares refit over their inliers
    and a re-score; the refit is kept where it did not lose inliers.
    """
    err, valid = geometric_verify_errors(gumbel, xn, kp_mask, pairs, matches,
                                         threshold=threshold)
    inliers = (err < threshold) & valid
    return inliers, torch.sum(inliers.to(torch.int32), dim=1)
