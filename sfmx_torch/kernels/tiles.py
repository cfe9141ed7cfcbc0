"""K9: tile-batched pairwise matching on Hopper (port of
``sfmx.kernels.pallas_tiles``).  Same contract as K5
(``pairs.match_pairs_fused``).

Production pair lists are a dense temporal band (window pairs) plus a few
retrieval extras, so each image takes part in ~window pairs.  The host
packs the pairs into (A-tile x B-tile) blocks of image-index space
(``pack_tiles``, bit-identical to the reference's); on the card a block of
the K5 kernel then owns 128 rows of one a-image and loops over the up to
Tb b-images its tile lists, so its A fragments load once for all of them
(the swapped list, for the column's best row, is grouped as K5 groups it).
Pairs in tiles with fewer than ``min_fill`` pairs go through K5.  K9's
arithmetic is K5's, element for element, so the two agree exactly.
Scores leave unpacked (f32 score, int32 index, bool valid): the reference's
bf16 score packing and its missing K/D checks are not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.masking import NEG_INF
from . import pairs as pairs_mod
from .matching import MatchResult, match_pairs_float


def pack_tiles(pairs: np.ndarray, n_images: int, *, Ta: int = 8,
               Tb: int = 8, min_fill: int = 8):
    """Host-side tile packing.  Returns
    (meta, pos, dense_idx, rest_idx, n_steps): meta is the flat int32
    array ([a_base, b_base] per step), dense_idx are original pair indices
    packed into tiles (in packing order), pos[j] is dense_idx[j]'s slot
    (step*P + ai*Tb+bj, P = Ta*Tb), rest_idx are original indices routed to
    the per-pair kernel (tiles with < min_fill pairs).

    Tile bases are clamped to n_images - T so edge tiles stay in range
    (local coords shift accordingly); requires n_images >= max(Ta, Tb).
    """
    pairs = np.asarray(pairs)
    P = Ta * Tb
    ta = pairs[:, 0] // Ta
    tb = pairs[:, 1] // Tb
    tile_id = ta * ((n_images + Tb - 1) // Tb) + tb
    order = np.argsort(tile_id, kind="stable")
    tid_sorted = tile_id[order]
    # boundaries of equal-tile runs
    starts = np.flatnonzero(np.r_[True, tid_sorted[1:] != tid_sorted[:-1]])
    ends = np.r_[starts[1:], len(order)]
    counts = ends - starts

    dense_runs = counts >= min_fill
    meta_rows = []
    dense_idx = []
    pos = []
    step = 0
    for s, e, dense in zip(starts, ends, dense_runs):
        if not dense:
            continue
        idx = order[s:e]
        a_base = min((pairs[idx[0], 0] // Ta) * Ta, n_images - Ta)
        b_base = min((pairs[idx[0], 1] // Tb) * Tb, n_images - Tb)
        for j in idx:
            ai = pairs[j, 0] - a_base
            bj = pairs[j, 1] - b_base
            dense_idx.append(j)
            pos.append(step * P + ai * Tb + bj)
        meta_rows.append(np.array([a_base, b_base], np.int32))
        step += 1
    rest_idx = order[np.repeat(~dense_runs, counts)]
    if step == 0:
        return None, None, None, np.asarray(rest_idx, np.int64), 0
    meta = np.concatenate(meta_rows).astype(np.int32)
    return (meta, np.asarray(pos, np.int64), np.asarray(dense_idx, np.int64),
            np.asarray(rest_idx, np.int64), step)


def tile_groups(pos: np.ndarray, dense_idx: np.ndarray, Tb: int):
    """The kernel's work list for the packed pairs: dense_idx sorted by
    slot (so the pairs of one (step, a-row of the tile) are consecutive,
    with b ascending) and the group boundaries (G+1,), one group per
    (step, ai)."""
    order = np.argsort(pos, kind="stable")
    slot_pairs = np.asarray(dense_idx)[order]
    grp = np.asarray(pos)[order] // Tb
    start = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])
    return slot_pairs, np.r_[start, len(grp)].astype(np.int32)


def match_pairs_float_tiled(descs: torch.Tensor, masks: torch.Tensor, pairs, *,
                            ratio: float = 0.8, cross_check: bool = True,
                            Ta: int = 8, Tb: int = 8, min_fill: int = 8) -> MatchResult:
    """Tile-batched pairwise matcher: dense band tiles through K9, the
    sparse leftovers through K5.  Same MatchResult contract as
    ``matching.match_pairs_float`` (outputs in the input pair order).  For
    CPU tensors both parts run the plain matcher; for CUDA tensors the
    kernels or an exception (D > 128)."""
    pairs_np = np.asarray(pairs.cpu() if torch.is_tensor(pairs) else pairs)
    C, K, _ = descs.shape
    Np = pairs_np.shape[0]
    if C < max(Ta, Tb) or Np == 0:
        return pairs_mod.match_pairs_fused(descs, masks, pairs_np, ratio=ratio,
                                           cross_check=cross_check)
    _meta, pos, dense_idx, rest_idx, n_steps = pack_tiles(
        pairs_np, C, Ta=Ta, Tb=Tb, min_fill=min_fill)
    dev = descs.device
    score = torch.full((Np, K), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((Np, K), dtype=torch.int64, device=dev)
    valid = torch.zeros((Np, K), dtype=torch.bool, device=dev)
    if n_steps > 0:
        slot_pairs, group_start = tile_groups(pos, dense_idx, Tb)
        rows = torch.as_tensor(slot_pairs, device=dev)
        if dev.type == "cpu":
            r = match_pairs_float(descs, masks, pairs_np[slot_pairs], ratio=ratio,
                                  cross_check=cross_check)
            score[rows], idx[rows], valid[rows] = r.score, r.idx, r.valid
        else:
            pairs_mod._check_cuda(descs, masks)
            idx32 = torch.zeros((Np, K), dtype=torch.int32, device=dev)
            pairs_mod.launch(descs, masks, pairs_np[slot_pairs], out=(score, idx32, valid),
                             out_row=slot_pairs, group_start=group_start, ratio=ratio,
                             cross_check=cross_check, name="match_pairs_tiled")
            idx[rows] = idx32[rows].to(torch.int64)
    if len(rest_idx) > 0:
        r = pairs_mod.match_pairs_fused(descs, masks, pairs_np[rest_idx], ratio=ratio,
                                        cross_check=cross_check)
        rows = torch.as_tensor(rest_idx, device=dev)
        score[rows], idx[rows], valid[rows] = r.score, r.idx, r.valid
    return MatchResult(idx=idx, valid=valid, score=score)
