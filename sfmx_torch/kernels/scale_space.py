"""K1/K2: scale-space diffusion and det-Hessian response on Hopper.

Port of ``sfmx.kernels.pallas_scale_space``.  ``diffuse_segment`` (K1) runs
every FED step of one level segment and ``response_levels`` (K2) the
det-Hessian of every level; both are CUDA kernels in
``sfmx_torch/csrc/scale_space.cu``.  Each wrapper runs its plain PyTorch
version for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.  Boundaries are periodic on both paths.

K1 is tiled: a block loads an output tile of ``TILE_H x TILE_W`` pixels with
a halo of 2 pixels per fused FED step into shared memory (the only place
that wraps indices), runs up to ``MAX_FUSED`` steps there and keeps the
tile's interior.  ``fused_chunks`` cuts a segment into such launches and
``diffuse_segment_tiled`` mirrors the decomposition in plain PyTorch for the
CPU tests.

K2 is one launch for all levels: a block loads an output tile of
``RESP_TILE_H x RESP_TILE_W`` pixels of one (image, level) plane with a halo
of 2 d (d = the level's aperture), computes Lx and Ly on tile + halo d in
shared memory and the determinant on the tile; ``response_levels_tiled``
mirrors that for the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .features import (ScaleSpaceConfig, _diffusion_step, contrast_k2,
                       gaussian_blur, hessian_response, level_taus, scharr_roll)

LIB = "scale_space"
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.ss_diffuse_fused.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.ss_diffuse_fused.restype = _I
        lib.ss_response_levels.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.ss_response_levels.restype = _I
        lib.ss_error_string.argtypes = [_I]
        lib.ss_error_string.restype = ctypes.c_char_p
        lib._sfmx_typed = True
    return lib


def _check_cuda(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {ndim}-d tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: {lib.ss_error_string(err).decode()} ({err})")


# ---------------------------------------------------------------------------
# K1 diffuse_segment
# ---------------------------------------------------------------------------


def diffuse_segment_plain(L: torch.Tensor, k2: torch.Tensor, taus: tuple) -> torch.Tensor:
    """Plain version of K1: the FED steps of one segment. L (B,H,W), k2 (B,)."""
    k2 = k2.reshape(-1, 1, 1)
    for tau in taus:
        L = _diffusion_step(L, k2, tau)
    return L


# The output tile of one block and the most FED steps one launch fuses (the
# kernel itself takes up to 8), chosen by ``chip_smoke.py --tune`` on a
# 32-image VGA batch.  The three shared-memory planes (L twice, the
# conductance) of tile + halo must fit the 227 KB a block may use on the
# H100: see ``_plane_bytes``.
TILE_H, TILE_W = 80, 160
MAX_FUSED = 6
SMEM_BYTES = 232448
MAX_PLANE_W = 224     # the kernel's widest plane row (tile + halo)


def _plane_bytes(n_steps: int, tile_h: int, tile_w: int) -> int:
    return 3 * 4 * (tile_h + 4 * n_steps) * (tile_w + 4 * n_steps)


def fused_chunks(taus: tuple, max_fused: int = MAX_FUSED) -> list[tuple]:
    """Cut a segment's FED steps into the fewest launches of at most
    ``max_fused`` steps each, as even as possible, in order."""
    n = len(taus)
    k = -(-n // max_fused)
    sizes = [n // k + (i < n % k) for i in range(k)] if k else []
    out, at = [], 0
    for m in sizes:
        out.append(tuple(taus[at:at + m]))
        at += m
    return out


def diffuse_segment_tiled(L: torch.Tensor, k2: torch.Tensor, taus: tuple,
                          tile: tuple = (TILE_H, TILE_W), max_fused: int = MAX_FUSED):
    """Plain-PyTorch mirror of the K1 kernel's decomposition, for tests: per
    launch of ``fused_chunks``, cut the image into tiles, load tile + halo
    (2 per step) with wrapped indices, run the steps on the padded tile and
    keep the interior.  The steps wrap inside the padded tile, which spoils
    2 pixels per step from its border inwards: exactly the halo."""
    B, H, W = L.shape
    th, tw = tile
    k2 = k2.reshape(-1, 1, 1)
    for chunk in fused_chunks(taus, max_fused):
        halo = 2 * len(chunk)
        out = torch.empty_like(L)
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                ys = torch.arange(y0 - halo, y0 + th + halo, device=L.device) % H
                xs = torch.arange(x0 - halo, x0 + tw + halo, device=L.device) % W
                t = L[:, ys][:, :, xs]
                for tau in chunk:
                    t = _diffusion_step(t, k2, tau)
                h, w = min(th, H - y0), min(tw, W - x0)
                out[:, y0:y0 + h, x0:x0 + w] = t[:, halo:halo + h, halo:halo + w]
        L = out
    return L


def _diffuse_fused(L, k2, taus: tuple, tile_h: int, tile_w: int) -> torch.Tensor:
    """One launch of K1: ``taus`` fused on tiles of tile_h x tile_w."""
    if _plane_bytes(len(taus), tile_h, tile_w) > SMEM_BYTES or tile_w + 4 * len(taus) > MAX_PLANE_W:
        raise ValueError(f"diffuse_segment: {len(taus)} fused steps on a {tile_h}x{tile_w} tile "
                         f"need {_plane_bytes(len(taus), tile_h, tile_w)} B of shared memory (at most "
                         f"{SMEM_BYTES}) and plane rows of {tile_w + 4 * len(taus)} (at most "
                         f"{MAX_PLANE_W})")
    lib = _lib()
    B, H, W = L.shape
    out = torch.empty_like(L)
    taus_c = (ctypes.c_float * len(taus))(*taus)
    err = lib.ss_diffuse_fused(L.data_ptr(), out.data_ptr(), k2.data_ptr(), taus_c, len(taus),
                               B, H, W, tile_h, tile_w, _build.stream_ptr(L.device))
    _raise_on(lib, err, "diffuse_segment")
    _build.LAUNCHES.add("diffuse_segment", 1)
    return out


def diffuse_segment(L: torch.Tensor, k2: torch.Tensor, taus: tuple) -> torch.Tensor:
    """K1: run the FED steps ``taus`` of one level segment, one launch per
    chunk of ``fused_chunks``.  Any image size: the tile load wraps.

    L (B,H,W) f32, k2 (B,) f32 per-image contrast^2 -> (B,H,W) f32.
    """
    if L.device.type == "cpu":
        return diffuse_segment_plain(L, k2, taus)
    _check_cuda(L, "L", 3)
    _check_cuda(k2, "k2", 1)
    if k2.shape[0] != L.shape[0] or k2.device != L.device:
        raise ValueError(f"k2 must be ({L.shape[0]},) on {L.device}")
    if not taus:
        return L.clone()
    for chunk in fused_chunks(taus):
        L = _diffuse_fused(L, k2, chunk, TILE_H, TILE_W)
    return L


# ---------------------------------------------------------------------------
# K2 response_levels
# ---------------------------------------------------------------------------


def response_levels_plain(levels: torch.Tensor, sigma_levels: tuple) -> torch.Tensor:
    """Plain version of K2: det-Hessian of every level, (B,L,H,W)."""
    return hessian_response(levels, ScaleSpaceConfig(tuple(sigma_levels)))


# The output tile of one block and its threads, chosen by ``chip_smoke.py
# --tune`` on a 32-image VGA batch.  Three shared-memory planes (the level on
# tile + halo 2 d, Lx and Ly on tile + halo d) at the largest aperture must
# fit the block: see ``_response_bytes``.
RESP_TILE_H, RESP_TILE_W = 48, 128
RESP_THREADS = 256


def _response_bytes(d: int, tile_h: int, tile_w: int) -> int:
    return 4 * ((tile_h + 4 * d) * (tile_w + 4 * d) + 2 * (tile_h + 2 * d) * (tile_w + 2 * d))


def response_levels_tiled(levels: torch.Tensor, sigma_levels: tuple,
                          tile: tuple = (RESP_TILE_H, RESP_TILE_W)) -> torch.Tensor:
    """Plain-PyTorch mirror of the K2 kernel's decomposition, for tests: per
    level (aperture d) and tile, load tile + halo 2 d with wrapped indices,
    take Scharr twice on the padded tile and keep the interior.  Each Scharr
    wraps inside the padded tile, which spoils d pixels from its border
    inwards: together exactly the halo."""
    B, L, H, W = levels.shape
    th, tw = tile
    out = torch.empty_like(levels)
    for i, d in enumerate(int(s) for s in sigma_levels):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                ys = torch.arange(y0 - 2 * d, y0 + th + 2 * d, device=levels.device) % H
                xs = torch.arange(x0 - 2 * d, x0 + tw + 2 * d, device=levels.device) % W
                Lx, Ly = scharr_roll(levels[:, i][:, ys][:, :, xs], dilation=d)
                Lxx, Lxy = scharr_roll(Lx, dilation=d)
                _, Lyy = scharr_roll(Ly, dilation=d)
                det = Lxx * Lyy - Lxy * Lxy
                h, w = min(th, H - y0), min(tw, W - x0)
                out[:, i, y0:y0 + h, x0:x0 + w] = det[:, 2 * d:2 * d + h, 2 * d:2 * d + w]
    return out


def _response_fused(levels: torch.Tensor, sigma_levels: tuple, tile_h: int, tile_w: int,
                    threads: int) -> torch.Tensor:
    """The one launch of K2 on tiles of tile_h x tile_w."""
    B, L, H, W = levels.shape
    ds = [int(s) for s in sigma_levels]
    if len(ds) != L or min(ds) < 1:
        raise ValueError(f"{len(ds)} apertures {ds} for {L} levels (each must be >= 1)")
    need = _response_bytes(max(ds), tile_h, tile_w)
    if need > SMEM_BYTES or tile_w + 4 * max(ds) > MAX_PLANE_W:
        raise ValueError(f"response_levels: aperture {max(ds)} on a {tile_h}x{tile_w} tile needs "
                         f"{need} B of shared memory (at most {SMEM_BYTES}) and plane rows of "
                         f"{tile_w + 4 * max(ds)} (at most {MAX_PLANE_W})")
    lib = _lib()
    resp = torch.empty_like(levels)
    err = lib.ss_response_levels(levels.data_ptr(), resp.data_ptr(), (ctypes.c_int * L)(*ds),
                                 B, L, H, W, tile_h, tile_w, threads,
                                 _build.stream_ptr(levels.device))
    _raise_on(lib, err, "response_levels")
    _build.LAUNCHES.add("response_levels", 1)
    return resp


def response_levels(levels: torch.Tensor, sigma_levels: tuple) -> torch.Tensor:
    """K2: det-Hessian response of all levels (B,L,H,W), aperture d = sigma,
    in one launch.  Any image size: the tile load wraps."""
    if levels.device.type == "cpu":
        return response_levels_plain(levels, sigma_levels)
    _check_cuda(levels, "levels", 4)
    return _response_fused(levels, sigma_levels, RESP_TILE_H, RESP_TILE_W, RESP_THREADS)


def build_scale_space_and_response(images: torch.Tensor, cfg: ScaleSpaceConfig):
    """(B,H,W) -> (levels, resp), both (B,L,H,W), through K1 and K2."""
    L = gaussian_blur(images, float(cfg.sigmas[0])).contiguous()
    k2 = contrast_k2(L).reshape(-1).contiguous()
    levels = [L]
    for taus in level_taus(cfg):
        L = diffuse_segment(L, k2, taus)
        levels.append(L)
    levels = torch.stack(levels, dim=1)
    return levels, response_levels(levels, cfg.sigma_levels)
