"""Descriptor matching helpers (port of the query-side part of
``sfmx.kernels.matching``): the match record and the Hamming distance of
packed binary descriptors.  Pair matching belongs to the map-build path."""
from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (Ka,) int64 best match index into B
    valid: torch.Tensor  # (Ka,) bool passed ratio + masks
    score: torch.Tensor  # (Ka,) similarity of the best match


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word read as uint32 (torch has no popcount):
    the SWAR bit trick, in int64 so no step overflows.  Returns int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(...,Ka,W) x (...,Kb,W) int32 words (uint32 bit patterns) ->
    (...,Ka,Kb) int32 Hamming distances.  One word at a time, so only one
    (...,Ka,Kb) temporary lives per step."""
    out = None
    for w in range(bits_a.shape[-1]):
        c = popcount32(bits_a[..., :, None, w] ^ bits_b[..., None, :, w])
        out = c if out is None else out + c
    return out.to(torch.int32)
