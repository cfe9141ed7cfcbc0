"""Fixed-order segment sums: the normal equations' sums over camera, point
and intrinsics-group ids (``sfmx.solvers.schur`` sums them with
``jax.ops.segment_sum``; no Pallas kernel).

``index_add_`` on CUDA tensors adds with float atomics, so its sums change
their last bits from run to run, and two builds of one map part ways.  Here
the order is fixed once per solve: ``segment_plan`` sorts the ids (stably)
and splits each segment into pieces of at most ``PIECE_ROWS`` sorted rows;
``segment_sum`` sums in that order.  On CUDA tensors it launches the
hand-written kernel (``csrc/segment_sum.cu``: a warp per piece, lane j
adding rows j, j+32, ... in turn, then a butterfly of shuffles; a second
launch sums the pieces of the segments longer than one, in piece order) or
raises; on CPU tensors it runs the plain version
(``torch.segment_reduce`` over the sorted rows in float64, a serial sum per
segment).
Either gives the same bits on every run.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

LIB = "segment_sum"
PIECE_ROWS = 2048        # sorted rows one warp sums: 64 a lane


class SegmentPlan(NamedTuple):
    """The order of the sums over one id array, fixed for a solve."""

    ids: torch.Tensor               # (O,) int64 the ids, in the rows' order
    n: int                          # segments
    perm: torch.Tensor              # (O,) the rows in segment order (int32 on CUDA)
    lengths: torch.Tensor           # (n,) int64 rows a segment
    piece_off: torch.Tensor         # (n_pieces+1,) int32 offsets of the pieces in that order
    seg_piece: torch.Tensor | None  # (n+1,) int32 pieces of each segment; None: one each


def segment_plan(ids: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of ``ids`` (O,) in [0, n), on their device.  One host sync
    (the longest segment), two more where a segment needs several pieces."""
    ids = ids.long()
    dev = ids.device
    perm = torch.argsort(ids, stable=True)
    bounds = torch.searchsorted(ids[perm], torch.arange(n + 1, dtype=torch.int64, device=dev))
    lengths = bounds[1:] - bounds[:-1]
    piece_off, seg_piece = bounds, None
    if n and int(lengths.max()) > PIECE_ROWS:
        pieces = torch.clamp((lengths + PIECE_ROWS - 1) // PIECE_ROWS, min=1)
        first = torch.cumsum(pieces, 0) - pieces                   # a segment's first piece
        seg = torch.repeat_interleave(torch.arange(n, device=dev), pieces)
        k = torch.arange(seg.shape[0], device=dev) - first[seg]
        piece_off = torch.cat([bounds[seg] + k * PIECE_ROWS, bounds[-1:]])
        seg_piece = torch.cat([first, first[-1:] + pieces[-1:]]).int()
    index = torch.int32 if dev.type == "cuda" else torch.int64
    return SegmentPlan(ids, n, perm.to(index), lengths, piece_off.int(), seg_piece)


def segment_sum_plain(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The plain version: (O, ...) -> (n, ...), each segment's rows added in
    sorted order, one after another, in float64 (a serial float32 sum of an
    intrinsics group's hundreds of thousands of rows would drift by ~1e-5
    of the sum, more than the kernel's pieces and lanes do)."""
    srt = x.index_select(0, plan.perm).to(torch.float64)
    return torch.segment_reduce(srt, "sum", lengths=plan.lengths, axis=0,
                                unsafe=True).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        _P, _I = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum.argtypes = [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P]
        lib.segment_sum.restype = _I
        lib.segment_sum_error_string.argtypes = [_I]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        lib._sfmx_typed = True
    return lib


def segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(O, ...) rows summed by segment in the plan's order -> (n, ...).
    x float32 or float64 on the plan's device; the kernel on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu" and plan.perm.device.type == "cpu":
        return segment_sum_plain(x, plan)
    if x.device.type != "cuda" or plan.perm.device != x.device:
        raise ValueError(f"segment_sum: x on {x.device} and its plan on {plan.perm.device}: "
                         "both must be on one CUDA device (or both on the CPU)")
    if x.dtype not in (torch.float32, torch.float64) or x.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"segment_sum: x must be float32/float64 with {plan.perm.shape[0]} "
                         f"rows, got {x.dtype} {tuple(x.shape)}")
    D = math.prod(x.shape[1:])
    out = torch.empty((plan.n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if plan.n == 0 or D == 0:
        return out.zero_()
    x = x.contiguous()
    n_pieces = plan.piece_off.shape[0] - 1
    split = plan.seg_piece is not None
    partial = torch.empty((n_pieces, D), dtype=x.dtype, device=x.device) if split else None
    lib = _lib()
    err = lib.segment_sum(x.data_ptr(), plan.perm.data_ptr(), plan.piece_off.data_ptr(), n_pieces,
                          plan.seg_piece.data_ptr() if split else None, plan.n, D,
                          partial.data_ptr() if split else None, out.data_ptr(),
                          int(x.dtype == torch.float64), _build.stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"segment_sum: {lib.segment_sum_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add("segment_sum", 2 if split else 1)
    return out
