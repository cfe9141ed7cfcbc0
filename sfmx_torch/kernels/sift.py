"""SIFT-family extractor: DoG detection + gradient-histogram descriptor
(port of ``sfmx.kernels.sift``).

The selectable alternative to the AKAZE analog, built the reference's way:

  * a Gaussian pyramid and its differences at one flat resolution per
    octave (every level a (B,H,W) plane, so the pyramid is batched
    separable convolutions);
  * extrema by the AKAZE analog's blocked top-K NMS (``features.detect``)
    on |DoG|, so minima and maxima both fire, after the edge rejection on
    the Hessian's trace^2/det ratio;
  * the 4x4x8 descriptor with static soft-binning weights: the 16x16 sample
    grid is fixed in the patch frame, so the spatial cell weights are a
    constant (256,16) matrix and the orientation binning a closed-form
    (256,8) triangular kernel, contracted per keypoint in one einsum.

Plain PyTorch on any device (the reference has no Pallas kernel here).  The
output is the same ``Features`` record as the AKAZE analog's, so matching,
SfM and localization are extractor-agnostic.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .features import (N_WORDS, Features, Keypoints, _bilinear, _downsample2, _grid,
                       _kp_chunks, _orientation, detect, gaussian_blur,
                       merge_octave_features)

# flat pyramid: sigma_i = SIGMA0 * STEP^i
SIGMA0 = 1.6
STEP = 2 ** 0.5
N_LEVELS = 6          # DoG levels = N_LEVELS - 1
EDGE_R = 10.0         # SIFT edge-rejection curvature ratio
N_CELLS = 4           # 4x4 spatial cells
N_ORI = 8             # orientation bins
PATCH_N = 16          # 16x16 samples
DESC_DIM = N_CELLS * N_CELLS * N_ORI  # = 128


class SiftScales(NamedTuple):
    """Duck-typed stand-in for ScaleSpaceConfig inside features.detect."""

    sigma_list: tuple

    @property
    def sigmas(self) -> np.ndarray:
        return np.asarray(self.sigma_list, np.float32)

    @property
    def n_levels(self) -> int:
        return len(self.sigma_list)


def _dog_scales() -> SiftScales:
    # sigma of DoG level i ~ geometric mean of the two gaussians
    s = [float(SIGMA0 * STEP ** i) for i in range(N_LEVELS)]
    return SiftScales(tuple(np.sqrt(s[i] * s[i + 1]) for i in range(N_LEVELS - 1)))


def build_dog(images: torch.Tensor):
    """(B,H,W) -> (Gaussian levels (B,L,H,W), DoG (B,L-1,H,W))."""
    levels = []
    prev_sigma = 0.0
    L = images
    for i in range(N_LEVELS):
        sigma = SIGMA0 * STEP ** i
        inc = float(np.sqrt(max(sigma * sigma - prev_sigma * prev_sigma, 1e-6)))
        L = gaussian_blur(L, inc)
        prev_sigma = sigma
        levels.append(L)
    G = torch.stack(levels, dim=1)
    return G, G[:, 1:] - G[:, :-1]


def _edge_mask(dog: torch.Tensor) -> torch.Tensor:
    """SIFT edge rejection on each DoG plane: tr^2/det < (r+1)^2/r."""
    r = torch.roll
    Dxx = r(dog, -1, -1) + r(dog, 1, -1) - 2 * dog
    Dyy = r(dog, -1, -2) + r(dog, 1, -2) - 2 * dog
    Dxy = 0.25 * (r(r(dog, -1, -1), -1, -2) - r(r(dog, 1, -1), -1, -2)
                  - r(r(dog, -1, -1), 1, -2) + r(r(dog, 1, -1), 1, -2))
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    thresh = (EDGE_R + 1.0) ** 2 / EDGE_R
    return (det > 0) & (tr * tr < thresh * det)


def detect_sift(images: torch.Tensor, *, max_keypoints: int = 512,
                threshold: float = 0.015, oriented: bool = False):
    """DoG extrema -> (Keypoints, the Gaussian levels for description)."""
    G, dog = build_dog(images)
    resp = torch.where(_edge_mask(dog), torch.abs(dog), torch.zeros_like(dog))
    # the blocked top-K NMS detector; subpixel refinement runs on |DoG|
    kp = detect(G[:, :-1], resp, _dog_scales(), max_keypoints=max_keypoints,
                threshold=threshold, with_orientation=False)
    if oriented:
        angle = _orientation(G[:, :-1], kp.level, torch.round(kp.uv[..., 1]).long(),
                             torch.round(kp.uv[..., 0]).long(), kp.sigma)
        kp = kp._replace(angle=angle)
    return kp, G


def _static_spatial_weights() -> np.ndarray:
    """(256,16) bilinear soft-assignment of the fixed 16x16 grid to 4x4 cells."""
    pos = (np.arange(PATCH_N) + 0.5) * N_CELLS / PATCH_N  # in cell units [0,4)
    w = np.zeros((PATCH_N, N_CELLS), np.float32)
    for i, p in enumerate(pos):
        c = p - 0.5  # cell-center coordinate
        c0 = int(np.floor(c))
        f = c - c0
        if 0 <= c0 < N_CELLS:
            w[i, c0] += 1.0 - f
        if 0 <= c0 + 1 < N_CELLS:
            w[i, c0 + 1] += f
    W = np.einsum("ya,xb->yxab", w, w).reshape(PATCH_N * PATCH_N, N_CELLS * N_CELLS)
    return W.astype(np.float32)


_W_SPATIAL = _static_spatial_weights()


def describe_sift(G: torch.Tensor, kp: Keypoints) -> torch.Tensor:
    """4x4x8 gradient-histogram descriptors, (B,K,128) L2-normalized, on
    the patch of 12 sigma rotated by each keypoint's angle."""
    B, K = kp.level.shape
    dev = G.device
    g = _grid(PATCH_N).to(dev)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    gweight = torch.exp(-0.5 * (gx ** 2 + gy ** 2) / 0.25 ** 2).reshape(-1)
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    Wsp = torch.as_tensor(_W_SPATIAL, device=dev)                     # (S,16)
    centers = torch.arange(N_ORI, dtype=torch.float32, device=dev) + 0.5
    lv = G[:, :-1]
    out = []
    for sl in _kp_chunks(K, B, PATCH_N * PATCH_N):
        span = (12.0 * kp.sigma[:, sl])[..., None]
        ca = torch.cos(kp.angle[:, sl])[..., None]
        sa = torch.sin(kp.angle[:, sl])[..., None]
        px, py = gx * span, gy * span
        x = px * ca - py * sa + kp.uv[:, sl, 0:1]
        y = px * sa + py * ca + kp.uv[:, sl, 1:2]
        vals = _bilinear(lv, kp.level[:, sl], x, y).reshape(B, -1, PATCH_N, PATCH_N)
        dx = torch.gradient(vals, dim=-1)[0].flatten(2)                # patch-frame grads
        dy = torch.gradient(vals, dim=-2)[0].flatten(2)
        mag = torch.sqrt(dx * dx + dy * dy + 1e-12) * gweight
        theta = torch.atan2(dy, dx)                                    # [-pi, pi]
        # triangular soft binning over 8 circular bins
        bin_pos = (theta + math.pi) * (N_ORI / (2.0 * math.pi))        # [0,8]
        d = torch.abs(bin_pos[..., None] - centers)
        d = torch.minimum(d, N_ORI - d)                                # circular
        Wori = torch.clamp(1.0 - d, min=0.0)                           # (B,k,S,8)
        v = torch.einsum("sc,bkso,bks->bkco", Wsp, Wori, mag).flatten(2)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)
        v = torch.clamp(v, max=0.2)                                    # SIFT clip
        out.append(v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                   min=1e-8))
    desc = torch.cat(out, dim=1)
    return torch.where(kp.mask[..., None], desc, torch.zeros_like(desc))


def _binarize(desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """LSH-style sign bits against each descriptor's mean -> (B,K,4) int32
    words with the reference's uint32 bit patterns."""
    bits = desc > desc.mean(dim=-1, keepdim=True)
    w = bits.reshape(*bits.shape[:-1], 4, 32).to(torch.int64)
    words = torch.sum(w << torch.arange(32, device=desc.device), dim=-1)   # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return torch.where(mask[..., None], words, torch.zeros_like(words))


def _extract_sift_octave(images: torch.Tensor, max_keypoints: int, threshold: float,
                         oriented: bool) -> Features:
    kp, G = detect_sift(images, max_keypoints=max_keypoints, threshold=threshold,
                        oriented=oriented)
    desc = describe_sift(G, kp)
    # bits padded to the shared word count so Features keeps one layout
    bits = F.pad(_binarize(desc, kp.mask), (0, N_WORDS - 4))
    return Features(kp=kp, desc=desc, desc_bits=bits)


def detect_and_describe_sift(images: torch.Tensor, *, max_keypoints: int = 512,
                             threshold: float = 0.015, oriented: bool = False,
                             n_octaves: int = 1) -> Features:
    """Full SIFT-family extraction, a drop-in alternative to the AKAZE analog.

    ``threshold`` is the |DoG| contrast threshold on [0,1] images.  SIFT is
    exactly 128-d, the shared float width.  n_octaves > 1 adds
    2x-downsampled octaves merged as the AKAZE analog's
    (``features.merge_octave_features``).
    """
    if n_octaves <= 1:
        return _extract_sift_octave(images, max_keypoints, threshold, oriented)
    parts = []
    img_o = images
    for o in range(n_octaves):
        if o:
            img_o = _downsample2(img_o)
        k_o = max(64, max_keypoints >> o)
        parts.append(_extract_sift_octave(img_o, k_o, threshold, oriented))
    return merge_octave_features(parts, _dog_scales().n_levels, max_keypoints)
