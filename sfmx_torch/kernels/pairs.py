"""K5 and K10: per-pair brute-force matching on Hopper (port of
``sfmx.kernels.pallas_pairs``).

``match_pairs_fused`` (K5) matches image a against image b for every listed
pair: the (K,K) bf16 similarity with f32 accumulation, masked columns at
NEG, the row top-2, the Lowe ratio test and the mutual-best check, with the
dense matcher's semantics (``matching.match_pairs_float``, its plain
version): masked rows and columns both drop out, the cross-check is by
index, and a masked row's score is NEG with index 0.  (The Pallas kernel
masks only columns and takes the column max over every row, which makes it
conservative under partial masks; the port holds the dense contract.)
``match_pairs_top2`` (K10) is the same CUDA kernel in its raw mode: no
masks and no tests, it returns s1, i1, s2 and the column argmax j1.

For a CUDA tensor the wrappers launch ``sfmx_torch/csrc/match_pairs.cu``
(two launches: the pair kernel, then the finish kernel) or raise; for CPU
tensors they run the plain versions.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core.masking import topk_lowest_index
from . import _build
from .matching import CHUNK_ELEMS, MatchResult, _bf16_sim, match_pairs_float

LIB = "match_pairs"
D_MAX = 128          # the kernel's descriptor width; narrower rows are zero-padded
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.mp_match_pairs.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _F, _I,
                                       _P, _P, _P, _P, _P, _P, _P]
        lib.mp_match_pairs.restype = _I
        lib.mp_error_string.argtypes = [_I]
        lib.mp_error_string.restype = ctypes.c_char_p
        lib.mp_desc_width.restype = _I
        lib._sfmx_typed = True
    return lib


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _check_cuda(descs: torch.Tensor, *others: torch.Tensor) -> None:
    for x in (descs, *others):
        if x.device.type != "cuda" or x.device != descs.device:
            raise ValueError(f"all inputs must be on {descs.device} (CUDA), got {x.device}")
    if descs.ndim != 3 or not descs.is_floating_point():
        raise ValueError(f"descs must be (C,K,D) float, got {tuple(descs.shape)} {descs.dtype}")
    if descs.shape[2] > D_MAX:
        raise ValueError(f"the CUDA kernel needs D <= {D_MAX}, got D={descs.shape[2]}")


def launch(descs: torch.Tensor, masks: torch.Tensor | None, pairs: torch.Tensor, *,
           out: tuple, out_row: torch.Tensor | None = None,
           group_start: torch.Tensor | None = None, s2: torch.Tensor | None = None,
           ratio: float = 0.8, cross_check: bool = True, name: str) -> None:
    """Run the pair kernel and its finish kernel on the listed pairs (CUDA
    only; the caller has checked the inputs).

    descs (C,K,D) float, masks (C,K) bool or None (raw mode), pairs (N,2) in
    processing order; ``out`` = (score f32, idx i32, valid bool) in match
    mode or (s1 f32, i1 i32, j1 i32) in raw mode, each (n_out,K), written at
    rows ``out_row`` (N,) (identity when None).  ``group_start`` (G+1,)
    groups consecutive pairs that share their a-image into one block
    (K9); None puts each pair in its own (K5).  ``s2`` (N,K) f32 receives
    the second-best scores in processing order (scratch when None).  Counts
    2 launches under ``name``.
    """
    C, K, D = descs.shape
    N = pairs.shape[0]
    if N == 0:
        return
    dev = descs.device
    d16 = F.pad(descs.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    m8 = None if masks is None else masks.to(torch.uint8).contiguous()
    p32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
    orow = None if out_row is None else out_row.to(device=dev, dtype=torch.int32).contiguous()
    gs = None if group_start is None else group_start.to(device=dev, dtype=torch.int32).contiguous()
    if s2 is None:
        s2 = torch.empty((N, K), dtype=torch.float32, device=dev)
    colkey = torch.empty((N, K), dtype=torch.int64, device=dev)
    score, idx, third = out
    raw = masks is None
    n_groups = N if gs is None else gs.shape[0] - 1
    lib = _lib()
    err = lib.mp_match_pairs(
        d16.data_ptr(), _ptr(m8), K, p32.data_ptr(), _ptr(orow), _ptr(gs), N, n_groups,
        float(ratio * ratio), int(cross_check), score.data_ptr(), idx.data_ptr(),
        s2.data_ptr(), colkey.data_ptr(), None if raw else third.data_ptr(),
        third.data_ptr() if raw else None, _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"{name}: {lib.mp_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add(name, 2)


def match_pairs_fused(descs: torch.Tensor, masks: torch.Tensor, pairs, *,
                      ratio: float = 0.8, cross_check: bool = True) -> MatchResult:
    """K5: drop-in for ``matching.match_pairs_float`` (fields (Np,K); idx
    int64).  descs (C,K,D) float with D <= 128 on the card, masks (C,K)
    bool, pairs (Np,2) ints (numpy or tensor)."""
    pairs_t = torch.as_tensor(np.asarray(pairs) if not torch.is_tensor(pairs) else pairs)
    if descs.device.type == "cpu":
        return match_pairs_float(descs, masks, pairs_t, ratio=ratio, cross_check=cross_check)
    _check_cuda(descs, masks)
    Np, K = pairs_t.shape[0], descs.shape[1]
    dev = descs.device
    score = torch.empty((Np, K), dtype=torch.float32, device=dev)
    idx = torch.empty((Np, K), dtype=torch.int32, device=dev)
    valid = torch.empty((Np, K), dtype=torch.bool, device=dev)
    launch(descs, masks, pairs_t, out=(score, idx, valid), ratio=ratio,
           cross_check=cross_check, name="match_pairs_fused")
    return MatchResult(idx=idx.to(torch.int64), valid=valid, score=score)


def match_pairs_top2_plain(descs: torch.Tensor, pairs):
    """Plain version of K10: (s1, i1, s2, j1), each (Np,K) (indices int32),
    with ``lax.top_k``'s and ``jnp.argmax``'s lowest-index tie rules,
    chunked over pairs."""
    pairs = torch.as_tensor(pairs, device=descs.device).to(torch.int64)
    K = descs.shape[1]
    step = max(1, CHUNK_ELEMS // (K * K))
    outs = []
    for s in range(0, pairs.shape[0], step):
        p = pairs[s:s + step]
        sim = _bf16_sim(descs[p[:, 0]], descs[p[:, 1]])
        v, i = topk_lowest_index(sim, 2)
        j1 = topk_lowest_index(sim.transpose(-1, -2), 1)[1][..., 0]
        outs.append((v[..., 0], i[..., 0].to(torch.int32), v[..., 1], j1.to(torch.int32)))
    if not outs:
        z = torch.zeros((0, K), device=descs.device)
        return z, z.to(torch.int32), z, z.to(torch.int32)
    return tuple(torch.cat(x) for x in zip(*outs))


def match_pairs_top2(descs: torch.Tensor, pairs):
    """K10: raw per-pair top-2 and column argmax, no masks and no tests.

    descs (C,K,D) float (masked rows pre-zeroed by the caller), pairs
    (Np,2).  Returns (s1 f32, i1 int32, s2 f32, j1 int32), each (Np,K):
    s1/i1 the best column of each a-row and its lowest index, s2 the best
    other column, j1 the first row attaining each b-column's max.
    """
    pairs_t = torch.as_tensor(np.asarray(pairs) if not torch.is_tensor(pairs) else pairs)
    if descs.device.type == "cpu":
        return match_pairs_top2_plain(descs, pairs_t)
    _check_cuda(descs)
    Np, K = pairs_t.shape[0], descs.shape[1]
    dev = descs.device
    s1 = torch.empty((Np, K), dtype=torch.float32, device=dev)
    i1 = torch.empty((Np, K), dtype=torch.int32, device=dev)
    j1 = torch.empty((Np, K), dtype=torch.int32, device=dev)
    s2 = torch.empty((Np, K), dtype=torch.float32, device=dev)
    launch(descs, None, pairs_t, out=(s1, i1, j1), s2=s2, name="match_pairs_top2")
    return s1, i1, s2, j1
