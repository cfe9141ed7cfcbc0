"""K4: streaming top-2 descriptor matching on Hopper (port of
``sfmx.kernels.pallas_match``).

``match_top2`` matches every query row against the whole landmark pool and
keeps only the best score, its index and the second-best score, so the
(Ka,Kb) similarity matrix never exists.  Inputs are rounded to bf16 and the
products accumulate in f32, as in the Pallas kernel.  For a CUDA tensor it
launches the hand-written kernel in ``sfmx_torch/csrc/match_top2.cu``;
``match_top2_plain`` is its plain PyTorch version, which the wrapper runs
for CPU tensors only.  ``match_float_streaming`` adds masks, zero padding
and the Lowe ratio test on top.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.masking import round_up, topk_lowest_index
from . import _build
from .matching import MatchResult

LIB = "match_top2"
NEG = -1e30
D_MAX = 128          # the kernel's descriptor width; narrower rows are zero-padded
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.mt_match_top2.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P]
        lib.mt_match_top2.restype = _I
        lib.mt_error_string.argtypes = [_I]
        lib.mt_error_string.restype = ctypes.c_char_p
        lib.mt_tile_rows.restype = _I
        lib._sfmx_typed = True
    return lib


def match_top2_plain(desc_a: torch.Tensor, desc_b: torch.Tensor, *,
                     max_elems: int = 1 << 28):
    """Plain version of K4: (s1, i1, s2), each (Ka,).

    The bf16-rounded inputs go through an f32 matmul (with TF32 off, the
    products of bf16 values are exact), one landmark chunk at a time with a
    running top-2, so no more than ``max_elems`` scores exist at once.  The
    merge follows the Pallas kernel: a later chunk wins only on a strictly
    higher score, so the lowest index keeps a tie.
    """
    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    a = desc_a.to(torch.bfloat16).to(torch.float32)
    b = desc_b.to(torch.bfloat16).to(torch.float32)
    dev = desc_a.device
    s1 = torch.full((Ka,), NEG, dtype=torch.float32, device=dev)
    s2 = torch.full((Ka,), NEG, dtype=torch.float32, device=dev)
    i1 = torch.zeros((Ka,), dtype=torch.int32, device=dev)
    chunk = max(1, min(Kb, max_elems // max(Ka, 1)))
    for j0 in range(0, Kb, chunk):
        sim = a @ b[j0:j0 + chunk].T                        # (Ka, chunk)
        a1 = torch.argmax(sim, dim=1, keepdim=True)          # first max
        t1 = torch.gather(sim, 1, a1)[:, 0]
        t2 = torch.amax(sim.scatter_(1, a1, NEG), dim=1)     # excludes only a1
        take = t1 > s1
        s2 = torch.maximum(torch.minimum(s1, t1), torch.maximum(s2, t2))
        i1 = torch.where(take, (a1[:, 0] + j0).to(torch.int32), i1)
        s1 = torch.maximum(s1, t1)
    return s1, i1, s2


def match_top2(desc_a: torch.Tensor, desc_b: torch.Tensor, *,
               tile_a: int = 256, tile_b: int = 2048):
    """K4 streaming top-2: returns (s1 f32, i1 int32, s2 f32), each (Ka,).

    desc_a (Ka,D), desc_b (Kb,D) float; Ka % tile_a == 0 and Kb % tile_b == 0
    (pad with zero rows, as ``match_float_streaming`` does).  On the card
    D <= 128 and tile_b a multiple of 64.
    """
    Ka, D = desc_a.shape
    Kb, Db = desc_b.shape
    if D != Db or Ka % tile_a or Kb % tile_b:
        raise ValueError(f"match_top2 needs equal widths and Ka % tile_a == Kb % tile_b "
                         f"== 0, got {tuple(desc_a.shape)}, {tuple(desc_b.shape)}, "
                         f"tiles {tile_a}, {tile_b}")
    if desc_a.device.type == "cpu" and desc_b.device.type == "cpu":
        return match_top2_plain(desc_a, desc_b)
    for name, x in (("desc_a", desc_a), ("desc_b", desc_b)):
        if x.device.type != "cuda" or x.device != desc_a.device:
            raise ValueError(f"{name} must be on {desc_a.device} (CUDA), got {x.device}")
        if not x.is_floating_point():
            raise ValueError(f"{name} must be floating point, got {x.dtype}")
    lib = _lib()
    if D > D_MAX or Kb % lib.mt_tile_rows():
        raise ValueError(f"the CUDA kernel needs D <= {D_MAX} and Kb % "
                         f"{lib.mt_tile_rows()} == 0, got D={D}, Kb={Kb}")
    a16 = F.pad(desc_a.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    b16 = F.pad(desc_b.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    s1 = torch.empty((Ka,), dtype=torch.float32, device=desc_a.device)
    s2 = torch.empty_like(s1)
    i1 = torch.empty((Ka,), dtype=torch.int32, device=desc_a.device)
    err = lib.mt_match_top2(a16.data_ptr(), b16.data_ptr(), Ka, Kb, s1.data_ptr(),
                            i1.data_ptr(), s2.data_ptr(), _build.stream_ptr(desc_a.device))
    if err != 0:
        raise RuntimeError(f"match_top2: {lib.mt_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add("match_top2", int(Ka > 0))
    return s1, i1, s2


def match_top2_reference(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """Dense oracle (bf16-rounded inputs, f32 GEMM, whole (Ka,Kb) matrix,
    ``topk_lowest_index`` for the reference's ``lax.top_k`` tie rule)."""
    sim = (desc_a.to(torch.bfloat16).to(torch.float32)
           @ desc_b.to(torch.bfloat16).to(torch.float32).T)
    v, i = topk_lowest_index(sim, 2)
    return v[:, 0], i[:, 0].to(torch.int32), v[:, 1]


def match_float_streaming(desc_a: torch.Tensor, desc_b: torch.Tensor,
                          mask_a: torch.Tensor, mask_b: torch.Tensor, *,
                          ratio: float = 0.8, tile_a: int = 256,
                          tile_b: int = 2048) -> MatchResult:
    """Ratio-test matching of unit descriptors against a large pool on K4
    (no cross-check pass).

    Masked rows are zeroed, not dropped, and both sides are zero-padded to
    their tile multiples; pad rows score 0, so they can be the second best,
    or the best with an index >= Kb, which ``valid`` then rejects.
    """
    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    pa = round_up(max(Ka, tile_a), tile_a)
    pb = round_up(max(Kb, tile_b), tile_b)
    a = torch.where(mask_a[:, None], desc_a, torch.zeros_like(desc_a))
    b = torch.where(mask_b[:, None], desc_b, torch.zeros_like(desc_b))
    a = F.pad(a, (0, 0, 0, pa - Ka))
    b = F.pad(b, (0, 0, 0, pb - Kb))
    s1, i1, s2 = match_top2(a, b, tile_a=tile_a, tile_b=tile_b)
    s1, i1, s2 = s1[:Ka], i1[:Ka].to(torch.int64), s2[:Ka]
    d1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    idx = torch.clamp(i1, 0, Kb - 1)
    ok = (d1 < ratio * ratio * d2) & mask_a & (i1 < Kb) & mask_b[idx]
    return MatchResult(idx=idx, valid=ok, score=s1)
