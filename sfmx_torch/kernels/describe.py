"""K3: upright patch descriptors on Hopper (port of ``sfmx.kernels.pallas_describe``).

``describe_upright`` samples a 24x24 patch spanning 20 sigma around each
keypoint on its scale level and pools 87 cell features (2x2, 3x3, 4x4 grids
x mean, dx, dy) into a 128-wide row — one CUDA warp per keypoint, a lane per
patch column (``sfmx_torch/csrc/describe.cu``).  ``describe_upright_reference``
is its plain PyTorch version; the wrapper runs it for CPU tensors only.
``describe_upright_columns`` repeats the kernel's order of the pooling sums
on the CPU, for tests.
``finalize_float``/``finalize_bits`` turn raw cells into the float and the
packed binary descriptors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .features import _GRIDS, _PATCH, N_WORDS

WIN = 256           # reference window side: fixes the padding and origins
N_CELLS_RAW = sum(g * g for g in _GRIDS) * 3   # 87
OUT_DIM = 128
KP_PER_BLOCK = 2    # keypoints (warps) per block of the kernel (chip_smoke.py --tune)

LIB = "describe"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.dsc_describe_upright.argtypes = [_P, _P, _P, ctypes.c_bool, _P, _P, _P, _I, _I,
                                             _I, _I, _I, _I, _I, _F, _F, _I, _P]
        lib.dsc_describe_upright.restype = _I
        lib.dsc_error_string.argtypes = [_I]
        lib.dsc_error_string.restype = ctypes.c_char_p
        lib._sfmx_typed = True
    return lib


def padded_size(H: int, W: int) -> tuple[int, int]:
    """The zero-padded level size the sampling is defined on."""
    return max(((H + 7) // 8) * 8, WIN), max(((W + 127) // 128) * 128, WIN)


def _window_params(uv: torch.Tensor, sigma: torch.Tensor, H: int, W: int):
    """Aligned window origin + in-window center + sample spacing."""
    spacing = 20.0 * sigma / (_PATCH - 1)     # span 20 sigma over PATCH samples
    y0 = torch.floor(uv[..., 1] - 64.0).to(torch.int32)
    y0 = torch.clamp(torch.div(y0, 8, rounding_mode="floor") * 8, 0, H - WIN)
    x0 = torch.floor(uv[..., 0] - 64.0).to(torch.int32)
    x0 = torch.clamp(torch.div(x0, 128, rounding_mode="floor") * 128, 0, W - WIN)
    fx = uv[..., 0] - x0.to(torch.float32)
    fy = uv[..., 1] - y0.to(torch.float32)
    return y0, x0, fy, fx, spacing


def _gradients(patch: torch.Tensor):
    """In-patch gradients: one-sided at the edges, central inside."""
    dx = torch.cat([patch[..., :, 1:2] - patch[..., :, 0:1],
                    0.5 * (patch[..., :, 2:] - patch[..., :, :-2]),
                    patch[..., :, -1:] - patch[..., :, -2:-1]], dim=-1)
    dy = torch.cat([patch[..., 1:2, :] - patch[..., 0:1, :],
                    0.5 * (patch[..., 2:, :] - patch[..., :-2, :]),
                    patch[..., -1:, :] - patch[..., -2:-1, :]], dim=-2)
    return dx, dy


def _cells_from_patch(patch: torch.Tensor) -> torch.Tensor:
    """(...,PATCH,PATCH) -> (...,87) cell features [mean,dx,dy per grid]."""
    dx, dy = _gradients(patch)
    lead = patch.shape[:-2]
    outs = []
    for g in _GRIDS:
        cs = _PATCH // g
        for ch in (patch, dx, dy):
            m = ch.reshape(*lead, g, cs, g, cs).mean(dim=(-3, -1))
            outs.append(m.reshape(*lead, g * g))
    return torch.cat(outs, dim=-1)


def _sample_patches(levels, uv, level, sigma) -> torch.Tensor:
    """The (B,K,PATCH,PATCH) bilinear patches, rows y and columns x."""
    B, L, H, W = levels.shape
    K = uv.shape[1]
    Hp, Wp = padded_size(H, W)
    if (Hp, Wp) != (H, W):
        levels = F.pad(levels, (0, Wp - W, 0, Hp - H))
    y0, x0, fy, fx, sp = _window_params(uv, sigma, Hp, Wp)
    k = torch.arange(_PATCH, dtype=torch.float32, device=uv.device)
    off = (k - (_PATCH - 1) / 2.0) * sp[..., None]                 # (B,K,P)
    xs = x0.to(torch.float32)[..., None] + fx[..., None] + off
    ys = y0.to(torch.float32)[..., None] + fy[..., None] + off
    x = torch.clamp(xs[:, :, None, :].expand(B, K, _PATCH, _PATCH), 0.0, Wp - 1.001)
    y = torch.clamp(ys[:, :, :, None].expand(B, K, _PATCH, _PATCH), 0.0, Hp - 1.001)
    xi = torch.floor(x).to(torch.int64)
    yi = torch.floor(y).to(torch.int64)
    ax = x - xi
    ay = y - yi
    flat = levels.reshape(B, L * Hp * Wp)
    base = (level.to(torch.int64) * Hp)[:, :, None, None]

    def at(yy, xx):
        idx = ((base + yy) * Wp + xx).reshape(B, -1)
        return torch.gather(flat, 1, idx).reshape(B, K, _PATCH, _PATCH)

    return (at(yi, xi) * (1 - ax) * (1 - ay) + at(yi, xi + 1) * ax * (1 - ay)
            + at(yi + 1, xi) * (1 - ax) * ay + at(yi + 1, xi + 1) * ax * ay)


def _masked_row(cells: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    feats = F.pad(cells, (0, OUT_DIM - N_CELLS_RAW))
    return torch.where(mask[..., None], feats, torch.zeros_like(feats))


def describe_upright_reference(levels, uv, level, sigma, mask) -> torch.Tensor:
    """Plain version of K3: raw cell features (B,K,128) by gathers."""
    return _masked_row(_cells_from_patch(_sample_patches(levels, uv, level, sigma)), mask)


def describe_upright_columns(levels, uv, level, sigma, mask) -> torch.Tensor:
    """K3 with the kernel's order of the pooling sums, for tests: each patch
    column is summed over the row bands of the three grids (rows in order),
    then a cell adds its columns' band sums in order and divides by its
    area.  Sampling and gradients are the plain version's."""
    patch = _sample_patches(levels, uv, level, sigma)
    dx, dy = _gradients(patch)
    outs = []
    for g in _GRIDS:
        cs = _PATCH // g
        for ch in (patch, dx, dy):
            cells = []
            for by in range(g):
                band = ch[..., by * cs, :]
                for i in range(by * cs + 1, (by + 1) * cs):
                    band = band + ch[..., i, :]                   # (B,K,PATCH) column sums
                for bx in range(g):
                    t = band[..., bx * cs]
                    for x in range(bx * cs + 1, (bx + 1) * cs):
                        t = t + band[..., x]
                    cells.append(t / float(cs * cs))
            outs.append(torch.stack(cells, dim=-1))
    return _masked_row(torch.cat(outs, dim=-1), mask)


def describe_upright(levels, uv, level, sigma, mask,
                     keypoints_per_block: int = KP_PER_BLOCK) -> torch.Tensor:
    """K3: raw upright cell features (B,K,128) for all keypoints of a batch.

    levels (B,L,H,W) f32; uv (B,K,2) f32; level (B,K) int; sigma (B,K) f32;
    mask (B,K) bool.  Normalize with ``finalize_float``/``finalize_bits``.
    ``keypoints_per_block`` (1..16) is the kernel's block shape: a sweep
    parameter, it does not change the result.
    """
    dev = levels.device
    if dev.type == "cpu":
        return describe_upright_reference(levels, uv, level, sigma, mask)
    if dev.type != "cuda":
        raise ValueError(f"levels must be a CUDA or CPU tensor, got {dev}")
    B, L, H, W = levels.shape
    K = uv.shape[1]
    # checked, not converted: a cast or a copy would be a launch of its own
    for name, x, dts, shape in (("levels", levels, (torch.float32,), (B, L, H, W)),
                                ("uv", uv, (torch.float32,), (B, K, 2)),
                                ("level", level, (torch.int32, torch.int64), (B, K)),
                                ("sigma", sigma, (torch.float32,), (B, K)),
                                ("mask", mask, (torch.bool,), (B, K))):
        if x.device != dev or x.dtype not in dts or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {' or '.join(map(str, dts))} {shape} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    Hp, Wp = padded_size(H, W)
    lib = _lib()
    out = torch.empty((B, K, OUT_DIM), dtype=torch.float32, device=dev)
    err = lib.dsc_describe_upright(levels.data_ptr(), uv.data_ptr(), level.data_ptr(),
                                   level.dtype == torch.int64,
                                   sigma.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                   B, L, H, W, Hp, Wp, K, Wp - 1.001, Hp - 1.001,
                                   keypoints_per_block, _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"describe_upright: {lib.dsc_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add("describe_upright", int(B * K > 0))
    return out


def finalize_float(raw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-(grid,channel) standardization + global L2 norm -> (B,K,128)."""
    groups = []
    off = 0
    for gdim in _GRIDS:
        n = gdim * gdim
        for _ch in range(3):
            v = raw[..., off:off + n]
            off += n
            v = v - v.mean(dim=-1, keepdim=True)
            v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)
            groups.append(v)
    f = torch.cat(groups, dim=-1)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-8)
    f = F.pad(f, (0, OUT_DIM - f.shape[-1]))
    return torch.where(mask[..., None], f, torch.zeros_like(f))


def finalize_bits(raw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pack M-LDB comparison bits into (B,K,N_WORDS) int32 words whose bit
    patterns equal the reference's uint32 words (view them as uint32)."""
    bits = []
    off = 0
    for gdim in _GRIDS:
        n = gdim * gdim
        for _ch in range(3):
            v = raw[..., off:off + n]
            off += n
            iu, ju = np.triu_indices(n, k=1)
            bits.append(v[..., torch.as_tensor(iu, device=raw.device)]
                        > v[..., torch.as_tensor(ju, device=raw.device)])
    b = torch.cat(bits, dim=-1)
    b = F.pad(b, (0, N_WORDS * 32 - b.shape[-1]))
    w = b.reshape(*b.shape[:-1], N_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=raw.device)
    packed = torch.sum(w << shifts, dim=-1)                     # [0, 2^32)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)
    return torch.where(mask[..., None], packed, torch.zeros_like(packed))
