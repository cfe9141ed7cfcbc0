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
or raise; for CPU tensors they run the plain versions.  On the card one
launch runs the row top-2 of the listed pairs and the row top-1 of the
swapped pairs (a column's best row is the swapped pair's best column, see
the source), each list sorted by its row image and cut into groups of at
most ``PAIRS_PER_BLOCK`` pairs (``group_pairs``); in match mode a second
launch applies the tests.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core.masking import NEG_INF, topk_lowest_index
from . import _build
from .matching import CHUNK_ELEMS, MatchResult, _bf16_sim, match_pairs_float

LIB = "match_pairs"
D_MAX = 128          # the kernel's descriptor width; narrower rows are zero-padded
TILE = 128           # columns per tile; the mask bias rows are padded to a multiple
PAIRS_PER_BLOCK = 16  # pairs of one row image per block (``chip_smoke.py --tune``)
STAGES = 3           # tiles in the shared-memory ring (``chip_smoke.py --tune``)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.mp_match_pairs.argtypes = ([_P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                        _P, _F, _I] + [_P] * 5 + [_I, _P])
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


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def group_pairs(pairs: np.ndarray, out_row: np.ndarray, per_block: int):
    """The kernel's work list for one direction: the pairs sorted by their
    row image (stable), each image's pairs cut into groups of at most
    ``per_block``.  Returns (pairs, out_row) in that order and the group
    boundaries (G+1,) int32."""
    order = np.argsort(pairs[:, 0], kind="stable")
    ps, orow = pairs[order], out_row[order]
    n = len(ps)
    idx = np.arange(n)
    new_image = np.r_[True, ps[1:, 0] != ps[:-1, 0]] if n else np.zeros(0, bool)
    pos = idx - np.maximum.accumulate(np.where(new_image, idx, 0))
    return ps, orow, np.r_[np.flatnonzero(pos % per_block == 0), n].astype(np.int32)


def column_bias(masks: torch.Tensor) -> torch.Tensor:
    """The kernel's column bias table from (C,K) bool masks: (C, Kp/TILE,
    TILE + 4) f32, per image and tile of TILE columns 0 for an unmasked
    column and NEG for a masked one or one past K, then 1.0 where the tile
    holds such a column (only such a tile's accumulators start from its
    bias) and 3 unused zeros."""
    C, K = masks.shape
    Kp = -(-K // TILE) * TILE
    bias = F.pad(torch.where(masks, 0.0, NEG_INF).to(torch.float32), (0, Kp - K),
                 value=NEG_INF).reshape(C, Kp // TILE, TILE)
    flag = (bias != 0).any(dim=2, keepdim=True).to(torch.float32)
    return torch.cat([bias, F.pad(flag, (0, 3))], dim=2).contiguous()


def launch(descs: torch.Tensor, masks: torch.Tensor | None, pairs, *, out: tuple,
           out_row=None, group_start=None, s2: torch.Tensor | None = None,
           ratio: float = 0.8, cross_check: bool = True, name: str,
           pairs_per_block: int | None = None, stages: int | None = None) -> None:
    """Run the pair kernel (and its finish kernel in match mode) on the
    listed pairs (CUDA only; the caller has checked the inputs).

    descs (C,K,D) float, masks (C,K) bool or None (raw mode), pairs (N,2)
    ints; ``out`` = (score f32, idx i32, valid bool) in match mode or (s1
    f32, i1 i32, j1 i32) in raw mode, each (n_out,K), written at rows
    ``out_row`` (N,) (identity when None).  ``group_start`` (G+1,) gives
    the groups of consecutive pairs that share their a-image (K9's tile
    groups); None groups the list by ``group_pairs``.  ``s2`` (n_out,K) f32
    receives the second-best scores (scratch when None).  Counts 2 launches
    under ``name`` in match mode, 1 in raw mode.
    """
    C, K, D = descs.shape
    pairs_np = _host(pairs).astype(np.int32).reshape(-1, 2)
    N = len(pairs_np)
    if N == 0:
        return
    dev = descs.device
    raw = masks is None
    per_block = PAIRS_PER_BLOCK if pairs_per_block is None else pairs_per_block
    orow = np.arange(N, dtype=np.int32) if out_row is None else _host(out_row).astype(np.int32)
    if group_start is None:
        p0, o0, g0 = group_pairs(pairs_np, orow, per_block)
    else:
        p0, o0, g0 = pairs_np, orow, _host(group_start).astype(np.int32)
    swap = raw or cross_check
    p1, o1, g1 = (group_pairs(np.ascontiguousarray(pairs_np[:, ::-1]), orow, per_block) if swap
                  else (pairs_np[:0], orow[:0], np.zeros(1, np.int32)))
    parts = [p0.ravel(), o0, g0, p1.ravel(), o1, g1]
    at = np.cumsum([0] + [len(x) for x in parts])
    buf = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    ptr = [buf.data_ptr() + 4 * int(o) for o in at[:-1]]

    d16 = F.pad(descs.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    bias = column_bias(torch.ones((C, K), dtype=torch.bool, device=dev) if raw else masks)
    Kp = bias.shape[1] * TILE
    n_out = out[0].shape[0]
    if s2 is None:
        s2 = torch.empty((n_out, K), dtype=torch.float32, device=dev)
    score, idx, third = out
    j1 = third if raw else (torch.empty((n_out, K), dtype=torch.int32, device=dev) if swap
                            else None)
    m8 = None if raw else masks.to(torch.uint8).contiguous()
    lib = _lib()
    err = lib.mp_match_pairs(
        d16.data_ptr(), C, K, bias.data_ptr(), Kp, ptr[0], ptr[1], ptr[2], len(g0) - 1, N,
        ptr[3], ptr[4], ptr[5], len(g1) - 1, _ptr(m8), float(ratio * ratio), int(cross_check),
        score.data_ptr(), idx.data_ptr(), s2.data_ptr(), _ptr(j1),
        None if raw else third.data_ptr(), STAGES if stages is None else stages,
        _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"{name}: {lib.mp_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add(name, 1 if raw else 2)


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


def match_pairs_swapped_plain(descs: torch.Tensor, masks: torch.Tensor, pairs, *,
                              ratio: float = 0.8, cross_check: bool = True,
                              per_block: int = PAIRS_PER_BLOCK):
    """Plain-PyTorch mirror of the kernel's decomposition, for tests.  Both
    directions go through ``group_pairs`` and come back through their
    ``out_row``; a pair's columns are padded to a TILE multiple with the
    rows that follow the image in the (C*K, D) descriptor table (zeros past
    its end) and take the column bias (0, or NEG for a masked column and for
    j >= K) by an add; the row top-2 keeps the lowest index; j1 is the row
    top-1 of the swapped pair under the row image's column bias, its scores
    the listed pair's transposed (the card computes them with the same
    bf16 products in the same k-order); the finish applies the ratio test,
    the masks and the mutual check by index.  Returns (MatchResult with idx
    int64, j1 (Np,K) int64)."""
    C, K, D = descs.shape
    pairs_np = _host(pairs).astype(np.int32).reshape(-1, 2)
    N = len(pairs_np)
    bias = column_bias(masks)[:, :, :TILE].reshape(C, -1)
    Kp = bias.shape[1]
    flat = F.pad(descs.reshape(C * K, D), (0, 0, 0, Kp - K))
    sim = _bf16_sim(descs[pairs_np[:, 0]], descs[pairs_np[:, 1]]) if N else None
    orow = np.arange(N, dtype=np.int32)

    def padded(rows, img, real):
        """(K, Kp) scores of ``rows`` against image ``img``'s columns."""
        tail = _bf16_sim(rows, flat[img * K + K:img * K + Kp]) + bias[img, K:]
        return torch.cat([real + bias[img, :K], tail], dim=-1)

    score = torch.empty((N, K), dtype=torch.float32)
    idx = torch.empty((N, K), dtype=torch.int64)
    s2 = torch.empty((N, K), dtype=torch.float32)
    j1 = torch.empty((N, K), dtype=torch.int64)
    ps, o0, _g = group_pairs(pairs_np, orow, per_block)
    for (a, b), o in zip(ps, o0):
        v, i = topk_lowest_index(padded(descs[a], b, sim[o]), 2)
        score[o], idx[o], s2[o] = v[:, 0], i[:, 0], v[:, 1]
    ps, o1, _g = group_pairs(np.ascontiguousarray(pairs_np[:, ::-1]), orow, per_block)
    for (b, a), o in zip(ps, o1):
        j1[o] = topk_lowest_index(padded(descs[b], a, sim[o].T), 1)[1][:, 0]
    ma = masks[torch.as_tensor(pairs_np[:, 0]).long()]
    d1 = torch.clamp(2.0 - 2.0 * score, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    ok = (d1 < ratio * ratio * d2) & (score > NEG_INF / 2) & ma
    if cross_check:
        ok &= torch.gather(j1, 1, idx) == torch.arange(K)
    score = torch.where(ma, score, torch.full_like(score, NEG_INF))
    idx = torch.where(ma, idx, torch.zeros_like(idx))
    return MatchResult(idx=idx, valid=ok, score=score), j1


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
