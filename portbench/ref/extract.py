"""Plain feature extraction: the benchmark's own, frozen.

A copy of the upright AKAZE-analog path of ``sfmx_torch.kernels.features``
(with ``describe.describe_upright_reference`` and ``finalize_float``) as of
commit 9fe1547, in plain PyTorch with no kernel: Gaussian pre-blur, FED
Perona-Malik diffusion to integer sigma levels, scale-normalized
det-Hessian, 3x3x3 NMS with a block top-K, subpixel refinement, radius
suppression, upright 24x24 patch descriptors (87 cell means padded to 128,
standardized per group, L2-normalized), two octaves merged.

The benchmark makes its map's descriptors and its feature requests with it,
and the correctness check holds the program's extraction against it.
``dtype`` runs the arithmetic in another precision (the control).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

SIGMA_LEVELS = (2, 3, 4, 5, 6)
GRIDS = (2, 3, 4)
PATCH = 24
WIN = 256
N_CELLS_RAW = sum(g * g for g in GRIDS) * 3   # 87
OUT_DIM = 128


class Features(NamedTuple):
    uv: torch.Tensor      # (B,K,2) pixels
    mask: torch.Tensor    # (B,K)
    desc: torch.Tensor    # (B,K,128) unit rows, zero where masked


def _conv2d(x, k, dilation=1):
    kh, kw = k.shape
    return F.conv2d(x[:, None], k[None, None], dilation=dilation,
                    padding=((kh - 1) * dilation // 2, (kw - 1) * dilation // 2))[:, 0]


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x, sigma: float):
    k = torch.as_tensor(gaussian_kernel1d(sigma), device=x.device).to(x.dtype)
    return _conv2d(_conv2d(x, k[None, :]), k[:, None])


def _sh(x, dy: int, dx: int):
    if dy:
        x = torch.roll(x, -dy, dims=-2)
    if dx:
        x = torch.roll(x, -dx, dims=-1)
    return x


def scharr_roll(x, dilation: int = 1):
    d = dilation
    E, W_ = _sh(x, 0, d), _sh(x, 0, -d)
    N, S = _sh(x, -d, 0), _sh(x, d, 0)
    NE, NW = _sh(x, -d, d), _sh(x, -d, -d)
    SE, SW = _sh(x, d, d), _sh(x, d, -d)
    gx = (3.0 * (NE + SE - NW - SW) + 10.0 * (E - W_)) / 32.0
    gy = (3.0 * (SE + SW - NE - NW) + 10.0 * (S - N)) / 32.0
    return gx, gy


def fed_tau_schedule(T: float, tau_max: float = 0.25) -> np.ndarray:
    if T <= 0:
        return np.zeros(0, np.float32)
    n = 1
    while tau_max * n * (n + 1) / 3.0 < T:
        n += 1
    j = np.arange(n)
    tau = tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    return (tau * (T / tau.sum())).astype(np.float32)


def level_taus(sigma_levels=SIGMA_LEVELS) -> list[tuple[float, ...]]:
    times = 0.5 * np.asarray(sigma_levels, np.float32) ** 2
    return [tuple(float(t) for t in fed_tau_schedule(float(times[i] - times[i - 1])))
            for i in range(1, len(sigma_levels))]


def _diffusion_step(L, k2, tau: float):
    Lx, Ly = scharr_roll(L)
    g = 1.0 / (1.0 + (Lx * Lx + Ly * Ly) / k2)
    flux = 0.0
    for dims, s in ((1, 1), (1, -1), (2, 1), (2, -1)):
        flux = flux + 0.5 * (g + torch.roll(g, s, dims=dims)) * (torch.roll(L, s, dims=dims) - L)
    return L + tau * flux


def _percentile_linear(x, q: float):
    n = x.shape[1]
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * float(n - 1)
    low = int(torch.clamp(torch.floor(pos), 0, n - 1).item())
    high = int(torch.clamp(torch.ceil(pos), 0, n - 1).item())
    hw = (pos - torch.floor(pos)).item()
    lo_v = torch.kthvalue(x.float(), low + 1, dim=1).values.to(x.dtype)
    hi_v = torch.kthvalue(x.float(), high + 1, dim=1).values.to(x.dtype)
    return lo_v * (1.0 - hw) + hi_v * hw


def contrast_k2(L):
    Lx, Ly = scharr_roll(L)
    mag = torch.sqrt(Lx * Lx + Ly * Ly)
    k = torch.clamp(_percentile_linear(mag.reshape(mag.shape[0], -1), 70.0), min=1e-3)
    return (k * k)[:, None, None]


def scale_space(images):
    """(B,H,W) -> levels (B,L,H,W) and det-Hessian responses (B,L,H,W)."""
    L = gaussian_blur(images, float(SIGMA_LEVELS[0]))
    k2 = contrast_k2(L)
    levels = [L]
    for taus in level_taus():
        for tau in taus:
            L = _diffusion_step(L, k2, tau)
        levels.append(L)
    levels = torch.stack(levels, dim=1)
    resp = []
    for i, d in enumerate(SIGMA_LEVELS):
        Lx, Ly = scharr_roll(levels[:, i], dilation=d)
        Lxx, Lxy = scharr_roll(Lx, dilation=d)
        _, Lyy = scharr_roll(Ly, dilation=d)
        resp.append(Lxx * Lyy - Lxy * Lxy)
    return levels, torch.stack(resp, dim=1)


def _top_lowest_index(x, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect(resp, *, max_keypoints: int, threshold: float, border: int = 10):
    """Upright keypoints: (uv (B,K,2), level (B,K), sigma (B,K), vals, mask)."""
    B, L, H, W = resp.shape
    dev = resp.device
    pooled = F.max_pool2d(resp.reshape(B * L, 1, H, W), 3, stride=1, padding=1).reshape(B, L, H, W)
    is_max = (resp >= pooled) & (resp > threshold)
    inf_row = torch.full_like(resp[:, :1], -torch.inf)
    is_max &= (resp >= torch.cat([resp[:, 1:], inf_row], dim=1))
    is_max &= (resp >= torch.cat([inf_row, resp[:, :-1]], dim=1))
    ys, xs = torch.arange(H, device=dev), torch.arange(W, device=dev)
    bmask = (((ys >= border) & (ys < H - border))[:, None]
             & ((xs >= border) & (xs < W - border))[None, :])
    is_max &= bmask[None, None]
    masked = torch.where(is_max, resp, torch.full_like(resp, -torch.inf))
    Hp, Wp = H + (H % 2), W + (W % 2)
    if (Hp, Wp) != (H, W):
        masked = F.pad(masked, (0, Wp - W, 0, Hp - H), value=-torch.inf)
    RH, RW = Hp // 2, Wp // 2
    reduced = masked.reshape(B, L, RH, 2, RW, 2).amax(dim=(1, 3, 5))
    k_red = min(max_keypoints, RH * RW)
    vals, ridx = _top_lowest_index(reduced.reshape(B, -1), k_red)
    if k_red < max_keypoints:
        vals = F.pad(vals, (0, max_keypoints - k_red), value=-torch.inf)
        ridx = F.pad(ridx, (0, max_keypoints - k_red))
    mask = torch.isfinite(vals) & (vals > threshold)
    ry, rx = ridx // RW, ridx % RW
    K = max_keypoints
    blocks = masked.reshape(B, L, RH, 2, RW, 2).permute(0, 2, 4, 1, 3, 5).reshape(B, RH * RW, L * 4)
    block = torch.gather(blocks, 1, ridx[..., None].expand(B, K, L * 4))
    amax = torch.argmax(block, dim=-1)
    lvl = amax // 4
    iy = 2 * ry + (amax % 4) // 2
    ix = 2 * rx + amax % 2
    flat = resp.reshape(B, L * H * W)

    def grab(dy, dx):
        yy = torch.remainder(iy + dy, H)
        xx = torch.remainder(ix + dx, W)
        return torch.gather(flat, 1, (lvl * H + yy) * W + xx)

    c = grab(0, 0)
    e, w_, s, n = grab(0, 1), grab(0, -1), grab(1, 0), grab(-1, 0)
    dx, dy = 0.5 * (e - w_), 0.5 * (s - n)
    dxx, dyy = e + w_ - 2.0 * c, s + n - 2.0 * c
    dxy = 0.25 * (grab(1, 1) - grab(1, -1) - grab(-1, 1) + grab(-1, -1))
    det = dxx * dyy - dxy * dxy
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    ox = torch.clamp(-(dyy * dx - dxy * dy) / det, -0.5, 0.5)
    oy = torch.clamp(-(dxx * dy - dxy * dx) / det, -0.5, 0.5)
    uv = torch.stack([ix.to(resp.dtype) + ox, iy.to(resp.dtype) + oy], dim=-1)
    d2 = torch.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, dim=-1)
    order = torch.arange(K, device=dev)
    stronger = (vals[:, None, :] > vals[:, :, None]) | (
        (vals[:, None, :] == vals[:, :, None]) & (order[None, None, :] < order[None, :, None]))
    mask = mask & ~torch.any(stronger & (d2 < 9.0) & mask[:, None, :], dim=-1)
    sigma = torch.as_tensor(np.asarray(SIGMA_LEVELS, np.float32), device=dev).to(resp.dtype)[lvl]
    return uv, lvl, sigma, torch.where(mask, vals, torch.zeros_like(vals)), mask


def _padded_size(H: int, W: int):
    return max(((H + 7) // 8) * 8, WIN), max(((W + 127) // 128) * 128, WIN)


def _cells(patch):
    dx = torch.cat([patch[..., :, 1:2] - patch[..., :, 0:1],
                    0.5 * (patch[..., :, 2:] - patch[..., :, :-2]),
                    patch[..., :, -1:] - patch[..., :, -2:-1]], dim=-1)
    dy = torch.cat([patch[..., 1:2, :] - patch[..., 0:1, :],
                    0.5 * (patch[..., 2:, :] - patch[..., :-2, :]),
                    patch[..., -1:, :] - patch[..., -2:-1, :]], dim=-2)
    lead = patch.shape[:-2]
    outs = []
    for g in GRIDS:
        cs = PATCH // g
        for ch in (patch, dx, dy):
            outs.append(ch.reshape(*lead, g, cs, g, cs).mean(dim=(-3, -1)).reshape(*lead, g * g))
    return torch.cat(outs, dim=-1)


def _patches(levels, uv, level, sigma):
    """(B,K,PATCH,PATCH) bilinear patches of each keypoint on its level."""
    B, L, H, W = levels.shape
    K = uv.shape[1]
    Hp, Wp = _padded_size(H, W)
    if (Hp, Wp) != (H, W):
        levels = F.pad(levels, (0, Wp - W, 0, Hp - H))
    sp = 20.0 * sigma / (PATCH - 1)
    y0 = torch.floor(uv[..., 1] - 64.0).to(torch.int32)
    y0 = torch.clamp(torch.div(y0, 8, rounding_mode="floor") * 8, 0, Hp - WIN)
    x0 = torch.floor(uv[..., 0] - 64.0).to(torch.int32)
    x0 = torch.clamp(torch.div(x0, 128, rounding_mode="floor") * 128, 0, Wp - WIN)
    fx = uv[..., 0] - x0.to(uv.dtype)
    fy = uv[..., 1] - y0.to(uv.dtype)
    k = torch.arange(PATCH, dtype=uv.dtype, device=uv.device)
    off = (k - (PATCH - 1) / 2.0) * sp[..., None]
    xs = x0.to(uv.dtype)[..., None] + fx[..., None] + off
    ys = y0.to(uv.dtype)[..., None] + fy[..., None] + off
    x = torch.clamp(xs[:, :, None, :].expand(B, K, PATCH, PATCH), 0.0, Wp - 1.001)
    y = torch.clamp(ys[:, :, :, None].expand(B, K, PATCH, PATCH), 0.0, Hp - 1.001)
    xi = torch.clamp(torch.floor(x).to(torch.int64), 0, Wp - 2)
    yi = torch.clamp(torch.floor(y).to(torch.int64), 0, Hp - 2)
    ax, ay = x - xi, y - yi
    flat = levels.reshape(B, L * Hp * Wp)
    base = (level.to(torch.int64) * Hp)[:, :, None, None]

    def at(yy, xx):
        return torch.gather(flat, 1, ((base + yy) * Wp + xx).reshape(B, -1)).reshape(B, K, PATCH, PATCH)

    return (at(yi, xi) * (1 - ax) * (1 - ay) + at(yi, xi + 1) * ax * (1 - ay)
            + at(yi + 1, xi) * (1 - ax) * ay + at(yi + 1, xi + 1) * ax * ay)


def finalize(raw, mask):
    groups, off = [], 0
    for g in GRIDS:
        for _ch in range(3):
            v = raw[..., off:off + g * g]
            off += g * g
            v = v - v.mean(dim=-1, keepdim=True)
            groups.append(v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8))
    f = torch.cat(groups, dim=-1)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-8)
    f = F.pad(f, (0, OUT_DIM - f.shape[-1]))
    return torch.where(mask[..., None], f, torch.zeros_like(f))


def _octave(images, max_keypoints: int, threshold: float):
    levels, resp = scale_space(images)
    uv, lvl, sigma, vals, mask = detect(resp, max_keypoints=max_keypoints, threshold=threshold)
    raw = _cells(_patches(levels, uv, lvl, sigma))
    return uv, sigma, vals, mask, finalize(raw, mask)


def extract(images, *, max_keypoints: int = 1024, threshold: float = 1e-7,
            n_octaves: int = 2, dtype=torch.float32) -> Features:
    """(B,H,W) images in [0,1] -> Features, every octave's keypoints merged
    into one full-resolution set of ``max_keypoints`` slots."""
    img = images.to(dtype)
    parts = []
    for o in range(n_octaves):
        if o:
            B, H, W = img.shape
            h, w = (H // 2) * 2, (W // 2) * 2
            img = img[:, :h, :w].reshape(B, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        parts.append(_octave(img, max(64, max_keypoints >> o), threshold))
    if n_octaves == 1:
        uv, _sig, vals, mask, desc = parts[0]
        return Features(uv.float(), mask, desc.float())
    uv = torch.cat([p[0] * float(1 << o) + (float(1 << o) - 1.0) / 2.0
                    for o, p in enumerate(parts)], dim=1)
    sig = torch.cat([p[1] * float(1 << o) for o, p in enumerate(parts)], dim=1)
    resp0 = torch.cat([p[2] for p in parts], dim=1)
    mask = torch.cat([p[3] for p in parts], dim=1)
    desc = torch.cat([p[4] for p in parts], dim=1)
    B, Kt = resp0.shape
    dev = uv.device
    d2 = torch.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, dim=-1)
    si, sj = sig[:, :, None], sig[:, None, :]
    same_scale = torch.maximum(si, sj) < 1.6 * torch.minimum(si, sj)
    rad = 1.5 * torch.minimum(si, sj)
    order = torch.arange(Kt, device=dev)
    stronger = (resp0[:, None, :] > resp0[:, :, None]) | (
        (resp0[:, None, :] == resp0[:, :, None]) & (order[None, None, :] < order[None, :, None]))
    mask = mask & ~torch.any(stronger & same_scale & (d2 < rad * rad) & mask[:, None, :], dim=-1)
    rank_key = torch.as_tensor(np.concatenate(
        [np.arange(p[0].shape[1], dtype=np.float32) * (1 << o) for o, p in enumerate(parts)]),
        device=dev)
    key_sel = torch.where(mask, rank_key[None, :], torch.full_like(rank_key, 1e9)[None, :])
    _, sel = _top_lowest_index(-key_sel, max_keypoints)

    def take(x):
        return torch.take_along_dim(x, sel.reshape(B, max_keypoints, *([1] * (x.ndim - 2))), dim=1)

    return Features(take(uv).float(), take(mask), take(desc).float())


def extract_batched(images: np.ndarray, device, *, batch: int = 8, **kw) -> dict:
    """``extract`` over (N,H,W) host images ``batch`` at a time; numpy out."""
    out = {"uv": [], "mask": [], "desc": []}
    for s in range(0, len(images), batch):
        f = extract(torch.from_numpy(np.ascontiguousarray(images[s:s + batch])).to(device), **kw)
        out["uv"].append(f.uv.cpu().numpy())
        out["mask"].append(f.mask.cpu().numpy())
        out["desc"].append(f.desc.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
