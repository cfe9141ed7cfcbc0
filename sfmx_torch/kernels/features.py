"""Feature detection + upright description (port of ``sfmx.kernels.features``).

AKAZE-analog on a full-resolution nonlinear scale space: Gaussian pre-blur,
FED Perona-Malik diffusion to integer sigma levels, scale-normalized
det-Hessian response, 3x3x3 NMS with a hierarchical block top-K, subpixel
refinement and radius suppression, then upright patch descriptors.  Every
image yields exactly K keypoint slots with a validity mask.

The heavy stages run through the CUDA kernels K1 (diffusion), K2 (response)
and K3 (descriptor) via ``scale_space`` and ``describe``; the functions here
are also those kernels' plain versions' building blocks.  The oriented mode
(``_orientation``/``describe``) is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.masking import topk_lowest_index

# ---------------------------------------------------------------------------
# Convolution helpers ((B,H,W), single channel)
# ---------------------------------------------------------------------------


def _conv2d(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' 2D correlation of (B,H,W) with kernel (kh,kw)."""
    kh, kw = k.shape
    return F.conv2d(x[:, None], k[None, None],
                    padding=((kh - 1) // 2, (kw - 1) // 2))[:, 0]


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of (B,H,W)."""
    k = torch.as_tensor(gaussian_kernel1d(sigma), device=x.device)
    x = _conv2d(x, k[None, :])
    return _conv2d(x, k[:, None])


def _sh(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Periodic shift on the last two axes: out[y,x] = x[y+dy, x+dx]."""
    if dy:
        x = torch.roll(x, -dy, dims=-2)
    if dx:
        x = torch.roll(x, -dx, dims=-1)
    return x


def scharr_roll(x: torch.Tensor, dilation: int = 1):
    """Scharr derivatives (3x3/32 stencil) with periodic boundaries."""
    d = dilation
    E, W_ = _sh(x, 0, d), _sh(x, 0, -d)
    N, S = _sh(x, -d, 0), _sh(x, d, 0)
    NE, NW = _sh(x, -d, d), _sh(x, -d, -d)
    SE, SW = _sh(x, d, d), _sh(x, d, -d)
    gx = (3.0 * (NE + SE - NW - SW) + 10.0 * (E - W_)) / 32.0
    gy = (3.0 * (SE + SW - NE - NW) + 10.0 * (S - N)) / 32.0
    return gx, gy


# ---------------------------------------------------------------------------
# FED (fast explicit diffusion) schedule — host-side, static
# ---------------------------------------------------------------------------


def fed_tau_schedule(T: float, tau_max: float = 0.25) -> np.ndarray:
    """FED cycle step sizes covering total diffusion time T."""
    if T <= 0:
        return np.zeros(0, np.float32)
    n = 1
    while tau_max * n * (n + 1) / 3.0 < T:
        n += 1
    j = np.arange(n)
    tau = tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    tau = tau * (T / tau.sum())
    return tau.astype(np.float32)


def _diffusion_step(L: torch.Tensor, k2: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit Perona-Malik g2 step, half-point conductivities on the
    4-neighbour stencil, periodic boundaries.  L (B,H,W), k2 (B,1,1)."""
    Lx, Ly = scharr_roll(L)
    g = 1.0 / (1.0 + (Lx * Lx + Ly * Ly) / k2)
    gN = torch.roll(g, 1, dims=1)
    gS = torch.roll(g, -1, dims=1)
    gW = torch.roll(g, 1, dims=2)
    gE = torch.roll(g, -1, dims=2)
    LN = torch.roll(L, 1, dims=1)
    LS = torch.roll(L, -1, dims=1)
    LW = torch.roll(L, 1, dims=2)
    LE = torch.roll(L, -1, dims=2)
    flux = (
        0.5 * (g + gN) * (LN - L)
        + 0.5 * (g + gS) * (LS - L)
        + 0.5 * (g + gW) * (LW - L)
        + 0.5 * (g + gE) * (LE - L)
    )
    return L + tau * flux


def _percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=1)`` with linear interpolation, (B,N)->(B,).

    Two ``kthvalue`` selections per row: ``torch.quantile`` refuses inputs
    over 2**24 elements.  The position arithmetic runs in float32 like the
    reference's.
    """
    n = x.shape[1]
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * float(n - 1)
    low = torch.clamp(torch.floor(pos), 0, n - 1)
    high = torch.clamp(torch.ceil(pos), 0, n - 1)
    hw = (pos - torch.floor(pos)).item()
    lo_v = torch.kthvalue(x, int(low.item()) + 1, dim=1).values
    hi_v = torch.kthvalue(x, int(high.item()) + 1, dim=1).values
    return lo_v * (1.0 - hw) + hi_v * hw


def contrast_k2(L: torch.Tensor, percentile: float = 70.0) -> torch.Tensor:
    """Per-image contrast parameter^2 from the gradient-magnitude percentile.
    (B,H,W) -> (B,1,1)."""
    Lx, Ly = scharr_roll(L)
    mag = torch.sqrt(Lx * Lx + Ly * Ly)
    k = _percentile_linear(mag.reshape(mag.shape[0], -1), percentile)
    k = torch.clamp(k, min=1e-3)
    return (k * k)[:, None, None]


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------


class ScaleSpaceConfig(NamedTuple):
    """Integer scale levels: derivative aperture == sigma exactly."""

    sigma_levels: tuple = (2, 3, 4, 5, 6)

    @property
    def n_levels(self) -> int:
        return len(self.sigma_levels)

    @property
    def sigmas(self) -> np.ndarray:
        return np.asarray(self.sigma_levels, np.float32)


def level_taus(cfg: ScaleSpaceConfig) -> list[tuple[float, ...]]:
    """Static FED step sizes of each level segment (level i-1 -> i)."""
    times = 0.5 * cfg.sigmas ** 2
    return [tuple(float(t) for t in fed_tau_schedule(float(times[i] - times[i - 1])))
            for i in range(1, cfg.n_levels)]


def build_scale_space(images: torch.Tensor, cfg: ScaleSpaceConfig) -> torch.Tensor:
    """(B,H,W) -> levels (B,L,H,W) of nonlinearly diffused images (plain)."""
    L = gaussian_blur(images, float(cfg.sigmas[0]))
    k2 = contrast_k2(L)
    levels = [L]
    for taus in level_taus(cfg):
        for tau in taus:
            L = _diffusion_step(L, k2, tau)
        levels.append(L)
    return torch.stack(levels, dim=1)


def hessian_response(levels: torch.Tensor, cfg: ScaleSpaceConfig) -> torch.Tensor:
    """Scale-normalized det-Hessian per level (B,L,H,W) (plain): Scharr
    applied twice, dilated by d = sigma, periodic boundaries."""
    out = []
    for i in range(levels.shape[1]):
        d = int(cfg.sigma_levels[i])
        Lx, Ly = scharr_roll(levels[:, i], dilation=d)
        Lxx, Lxy = scharr_roll(Lx, dilation=d)
        _, Lyy = scharr_roll(Ly, dilation=d)
        out.append(Lxx * Lyy - Lxy * Lxy)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


class Keypoints(NamedTuple):
    uv: torch.Tensor        # (B,K,2) subpixel x,y in pixels
    level: torch.Tensor     # (B,K) int64 scale-space level
    sigma: torch.Tensor     # (B,K) scale
    angle: torch.Tensor     # (B,K) orientation (radians; 0 = upright)
    response: torch.Tensor  # (B,K)
    mask: torch.Tensor      # (B,K) bool valid


class Features(NamedTuple):
    kp: Keypoints
    desc: torch.Tensor       # (B,K,128) float
    desc_bits: torch.Tensor  # (B,K,N_WORDS) int32, bit-identical to uint32


def _maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """(B,L,H,W) -> same-shape 3x3 spatial max (-inf padding)."""
    B, L, H, W = x.shape
    return F.max_pool2d(x.reshape(B * L, 1, H, W), 3, stride=1,
                        padding=1).reshape(B, L, H, W)


def detect(levels: torch.Tensor, resp: torch.Tensor, cfg: ScaleSpaceConfig, *,
           max_keypoints: int = 512, threshold: float = 1e-5,
           border: int = 10) -> Keypoints:
    """Upright detection: 3x3x3 NMS, block top-K, subpixel refine, radius
    suppression.  ``levels`` is unused in upright mode (kept for parity of
    the signature with the reference's oriented path)."""
    B, L, H, W = resp.shape
    dev = resp.device
    neg = torch.tensor(-torch.inf, device=dev)
    pooled = _maxpool3x3(resp)
    is_max = (resp >= pooled) & (resp > threshold)
    inf_row = torch.full_like(resp[:, :1], -torch.inf)
    up = torch.cat([resp[:, 1:], inf_row], dim=1)
    dn = torch.cat([inf_row, resp[:, :-1]], dim=1)
    is_max &= (resp >= up) & (resp >= dn)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    bmask = (((ys >= border) & (ys < H - border))[:, None]
             & ((xs >= border) & (xs < W - border))[None, :])
    is_max &= bmask[None, None]

    masked = torch.where(is_max, resp, neg)
    # Hierarchical top-K: at most one surviving keypoint per (L,2,2) block
    # (NMS + radius-3 suppression), so max-reduce blocks first, then recover
    # the exact in-block argmax with a small gather.
    Hp, Wp = H + (H % 2), W + (W % 2)
    masked_p = F.pad(masked, (0, Wp - W, 0, Hp - H), value=-torch.inf) \
        if (Hp, Wp) != (H, W) else masked
    RH, RW = Hp // 2, Wp // 2
    reduced = masked_p.reshape(B, L, RH, 2, RW, 2).amax(dim=(1, 3, 5))
    k_red = min(max_keypoints, RH * RW)
    vals, ridx = topk_lowest_index(reduced.reshape(B, -1), k_red)
    if k_red < max_keypoints:
        pad = max_keypoints - k_red
        vals = F.pad(vals, (0, pad), value=-torch.inf)
        ridx = F.pad(ridx, (0, pad))
    mask = torch.isfinite(vals) & (vals > threshold)
    ry, rx = ridx // RW, ridx % RW
    K = max_keypoints
    # (B,K,L,2,2) source block of every winner, flattened (l, dy, dx)
    blocks = masked_p.reshape(B, L, RH, 2, RW, 2).permute(0, 2, 4, 1, 3, 5)
    blocks = blocks.reshape(B, RH * RW, L * 4)
    block = torch.gather(blocks, 1, ridx[..., None].expand(B, K, L * 4))
    amax = torch.argmax(block, dim=-1)
    lvl = amax // 4
    iy = 2 * ry + (amax % 4) // 2
    ix = 2 * rx + amax % 2

    # Subpixel refinement: 2D quadratic fit on the response at the level.
    flat = resp.reshape(B, L * H * W)

    def grab(dy, dx):
        # only masked slots reach past the border; keep their reads in range
        yy = torch.remainder(iy + dy, H)
        xx = torch.remainder(ix + dx, W)
        return torch.gather(flat, 1, (lvl * H + yy) * W + xx)

    c = grab(0, 0)
    e, w_, s, n = grab(0, 1), grab(0, -1), grab(1, 0), grab(-1, 0)
    dx = 0.5 * (e - w_)
    dy = 0.5 * (s - n)
    dxx = e + w_ - 2.0 * c
    dyy = s + n - 2.0 * c
    dxy = 0.25 * (grab(1, 1) - grab(1, -1) - grab(-1, 1) + grab(-1, -1))
    det = dxx * dyy - dxy * dxy
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    ox = torch.clamp(-(dyy * dx - dxy * dy) / det, -0.5, 0.5)
    oy = torch.clamp(-(dxx * dy - dxy * dx) / det, -0.5, 0.5)
    uv = torch.stack([ix.to(torch.float32) + ox, iy.to(torch.float32) + oy], dim=-1)

    # Cross-level radius suppression: kill any keypoint with a strictly
    # stronger (or equal-and-earlier) valid detection within 3 px.
    suppress_radius = 3.0
    d2 = torch.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, dim=-1)
    order = torch.arange(K, device=dev)
    stronger = (vals[:, None, :] > vals[:, :, None]) | (
        (vals[:, None, :] == vals[:, :, None]) & (order[None, None, :] < order[None, :, None]))
    dup = torch.any(stronger & (d2 < suppress_radius ** 2) & mask[:, None, :], dim=-1)
    mask = mask & ~dup

    sigma = torch.as_tensor(cfg.sigmas, device=dev)[lvl]
    return Keypoints(uv=uv, level=lvl, sigma=sigma, angle=torch.zeros_like(sigma),
                     response=torch.where(mask, vals, torch.zeros_like(vals)),
                     mask=mask)


# ---------------------------------------------------------------------------
# Description and the extraction entry point
# ---------------------------------------------------------------------------

_GRIDS = (2, 3, 4)  # cell partitions; channels (mean, dx, dy) each
N_BITS = sum(3 * (g * g) * (g * g - 1) // 2 for g in _GRIDS)  # 486
N_WORDS = (N_BITS + 31) // 32                       # 16 32-bit words
_PATCH = 24  # samples per side of the canonical patch


def _extract_octave(images: torch.Tensor, cfg: ScaleSpaceConfig,
                    max_keypoints: int, threshold: float) -> Features:
    """Single-octave upright extraction through K1/K2 and K3."""
    from . import describe as dsc
    from . import scale_space as ss

    levels, resp = ss.build_scale_space_and_response(images, cfg)
    kp = detect(levels, resp, cfg, max_keypoints=max_keypoints, threshold=threshold)
    raw = dsc.describe_upright(levels, kp.uv, kp.level, kp.sigma, kp.mask)
    return Features(kp=kp, desc=dsc.finalize_float(raw, kp.mask),
                    desc_bits=dsc.finalize_bits(raw, kp.mask))


def _downsample2(images: torch.Tensor) -> torch.Tensor:
    """(B,H,W) -> (B,H//2,W//2) 2x2 average pool (odd tails dropped)."""
    B, H, W = images.shape
    h, w = (H // 2) * 2, (W // 2) * 2
    return images[:, :h, :w].reshape(B, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def detect_and_describe(images: torch.Tensor, cfg: ScaleSpaceConfig = ScaleSpaceConfig(), *,
                        max_keypoints: int = 512, threshold: float = 1e-5,
                        oriented: bool = False, n_octaves: int = 1) -> Features:
    """Full extraction: (B,H,W) f32 in [0,1] -> Features with static K capacity.

    n_octaves > 1 adds 2x-downsampled octaves whose keypoints merge into one
    full-resolution set (kp.level encodes octave * n_levels + level).
    """
    if oriented:
        raise NotImplementedError("oriented descriptors are not ported yet; "
                                  "use the upright mode")
    if n_octaves <= 1:
        return _extract_octave(images, cfg, max_keypoints, threshold)
    parts = []
    img_o = images
    for o in range(n_octaves):
        if o:
            img_o = _downsample2(img_o)
        k_o = max(64, max_keypoints >> o)
        parts.append(_extract_octave(img_o, cfg, k_o, threshold))
    return merge_octave_features(parts, cfg.n_levels, max_keypoints)


def merge_octave_features(parts: list, n_levels: int, max_keypoints: int) -> Features:
    """Merge per-octave Features (parts[o] at 1/2^o resolution) into one
    full-resolution set: rescale uv/sigma, suppress cross-octave duplicates
    (single pass), then rank-interleaved selection of ``max_keypoints``."""
    uvs, levels, sigmas, angles, resps, masks, descs, bits = ([] for _ in range(8))
    for o, f in enumerate(parts):
        s = float(1 << o)
        uvs.append(f.kp.uv * s + (s - 1.0) / 2.0)
        sigmas.append(f.kp.sigma * s)
        levels.append(f.kp.level + o * n_levels)
        angles.append(f.kp.angle)
        resps.append(f.kp.response)
        masks.append(f.kp.mask)
        descs.append(f.desc)
        bits.append(f.desc_bits)
    uv, sig, resp0, mask = (torch.cat(x, dim=1) for x in (uvs, sigmas, resps, masks))
    B, Kt = resp0.shape
    dev = uv.device
    d2 = torch.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, dim=-1)
    sig_i, sig_j = sig[:, :, None], sig[:, None, :]
    same_scale = torch.maximum(sig_i, sig_j) < 1.6 * torch.minimum(sig_i, sig_j)
    rad = 1.5 * torch.minimum(sig_i, sig_j)
    order = torch.arange(Kt, device=dev)
    stronger = (resp0[:, None, :] > resp0[:, :, None]) | (
        (resp0[:, None, :] == resp0[:, :, None]) & (order[None, None, :] < order[None, :, None]))
    dup = torch.any(stronger & same_scale & (d2 < rad * rad) & mask[:, None, :], dim=-1)
    mask = mask & ~dup
    # Rank-interleaved selection: within-octave rank is the slot index, and
    # the smallest rank*2^octave keys give octave o a ~K/2^o share.
    rank_key = torch.as_tensor(np.concatenate(
        [np.arange(p.kp.uv.shape[1], dtype=np.float32) * (1 << o)
         for o, p in enumerate(parts)]), device=dev)
    key_sel = torch.where(mask, rank_key[None, :], torch.full_like(rank_key, 1e9)[None, :])
    _, sel = topk_lowest_index(-key_sel, max_keypoints)

    def take(x):
        idx = sel.reshape(B, max_keypoints, *([1] * (x.ndim - 2)))
        return torch.take_along_dim(x, idx, dim=1)

    kp = Keypoints(uv=take(uv), level=take(torch.cat(levels, dim=1)), sigma=take(sig),
                   angle=take(torch.cat(angles, dim=1)), response=take(resp0),
                   mask=take(mask))
    return Features(kp=kp, desc=take(torch.cat(descs, dim=1)),
                    desc_bits=take(torch.cat(bits, dim=1)))
