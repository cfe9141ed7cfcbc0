"""K1/K2: scale-space diffusion and det-Hessian response on Hopper.

Port of ``sfmx.kernels.pallas_scale_space``.  ``diffuse_segment`` (K1) runs
every FED step of one level segment and ``response_levels`` (K2) the
det-Hessian of every level; both are CUDA kernels in
``sfmx_torch/csrc/scale_space.cu``.  Each wrapper runs its plain PyTorch
version for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.  Boundaries are periodic on both paths.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .features import (ScaleSpaceConfig, _diffusion_step, contrast_k2,
                       gaussian_blur, hessian_response, level_taus)

LIB = "scale_space"
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.ss_diffuse_segment.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.ss_diffuse_segment.restype = _I
        lib.ss_response_levels.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
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


def diffuse_segment(L: torch.Tensor, k2: torch.Tensor, taus: tuple) -> torch.Tensor:
    """K1: run the FED steps ``taus`` of one level segment.

    L (B,H,W) f32, k2 (B,) f32 per-image contrast^2 -> (B,H,W) f32.
    """
    if L.device.type == "cpu":
        return diffuse_segment_plain(L, k2, taus)
    _check_cuda(L, "L", 3)
    _check_cuda(k2, "k2", 1)
    B, H, W = L.shape
    if k2.shape[0] != B or k2.device != L.device:
        raise ValueError(f"k2 must be ({B},) on {L.device}")
    if not taus:
        return L.clone()
    lib = _lib()
    out = torch.empty_like(L)
    tmp = torch.empty_like(L) if len(taus) > 1 else out
    taus_c = (ctypes.c_float * len(taus))(*taus)
    err = lib.ss_diffuse_segment(L.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                                 k2.data_ptr(), taus_c, len(taus), B, H, W,
                                 _build.stream_ptr(L.device))
    _raise_on(lib, err, "diffuse_segment")
    _build.LAUNCHES.add("diffuse_segment", len(taus))     # one launch per FED step
    return out


# ---------------------------------------------------------------------------
# K2 response_levels
# ---------------------------------------------------------------------------


def response_levels_plain(levels: torch.Tensor, sigma_levels: tuple) -> torch.Tensor:
    """Plain version of K2: det-Hessian of every level, (B,L,H,W)."""
    return hessian_response(levels, ScaleSpaceConfig(tuple(sigma_levels)))


def response_levels(levels: torch.Tensor, sigma_levels: tuple) -> torch.Tensor:
    """K2: det-Hessian response of all levels (B,L,H,W), aperture d = sigma."""
    if levels.device.type == "cpu":
        return response_levels_plain(levels, sigma_levels)
    _check_cuda(levels, "levels", 4)
    B, L, H, W = levels.shape
    if len(sigma_levels) != L:
        raise ValueError(f"{len(sigma_levels)} apertures for {L} levels")
    lib = _lib()
    resp = torch.empty_like(levels)
    lx = torch.empty_like(levels)
    ly = torch.empty_like(levels)
    ds = (ctypes.c_int * L)(*[int(s) for s in sigma_levels])
    err = lib.ss_response_levels(levels.data_ptr(), resp.data_ptr(), lx.data_ptr(),
                                 ly.data_ptr(), ds, B, L, H, W,
                                 _build.stream_ptr(levels.device))
    _raise_on(lib, err, "response_levels")
    _build.LAUNCHES.add("response_levels", 2)             # gradients, then det
    return resp


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
