"""Host-side layout for point-sharded (block-partitioned) distributed BA
(a copy of ``sfmx.dist.block_layout``: host numpy, so the layouts are the
reference's bit for bit).

``partition_trajectory`` (mapstore.partition) cuts the trajectory into
contiguous camera blocks balanced by observation load and assigns each
landmark to the block holding most of its observations.  This module turns
that partition into the flat per-rank arrays the sharded solver
(dist.block_ba) consumes:

  * every rank owns ONE block: its cameras (Cb slots), its points
    (Pb slots ~ P/n), and its observations (Ob slots) — 1/n-sized state,
    unlike dist_ba which replicates all cameras/points per rank;
  * observations live on the rank of their CAMERA, so all camera-side
    reductions are rank-local;
  * observations of a point owned by another block reference it through a
    fixed-capacity HALO slot: extended point index
    ``Pb + owner_block*Hcap + slot``.  Owners export their boundary points
    (``halo_idx``/``halo_mask``) each iteration; the solver's only
    cross-rank traffic is O(Hcap) halo exchange, never O(P).

All index plumbing is computed once here with vectorized numpy; the solver
sees only flat arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..mapstore.partition import Partition, partition_trajectory


def _roundup(x: int, m: int) -> int:
    return max(((int(x) + m - 1) // m) * m, m)


class BlockLayout(NamedTuple):
    """Flat stacked per-device arrays (leading dim = n_blocks * capacity)."""

    n_blocks: int
    cb: int                  # camera slots per block
    pb: int                  # point slots per block (~ n_pts / n_blocks)
    ob: int                  # observation slots per block
    hcap: int                # halo export slots per block
    cam_global: np.ndarray   # (n*Cb,) global camera id, -1 = pad
    pt_global: np.ndarray    # (n*Pb,) global point id,  -1 = pad
    obs_cam_l: np.ndarray    # (n*Ob,) local camera index in [0, Cb)
    obs_pt_ext: np.ndarray   # (n*Ob,) extended point index in [0, Pb+n*Hcap)
    obs_uv: np.ndarray       # (n*Ob,2)
    obs_w: np.ndarray        # (n*Ob,) 0 for pad rows
    halo_idx: np.ndarray     # (n*Hcap,) local point row each block exports
    halo_mask: np.ndarray    # (n*Hcap,) bool validity of export slots
    part: Partition          # partition stats (halo fraction, block loads)

    def stats(self) -> dict:
        counts = self.part.block_obs_counts()
        return {
            "n_blocks": self.n_blocks,
            "halo_fraction": round(self.part.halo_fraction(), 5),
            "halo_capacity": self.hcap,
            "pts_per_device": self.pb,
            "cams_per_device": self.cb,
            "obs_per_device": self.ob,
            "block_obs_min": int(counts.min()) if counts.size else 0,
            "block_obs_max": int(counts.max()) if counts.size else 0,
        }


def build_block_layout(cam_id: np.ndarray, pt_id: np.ndarray, uv: np.ndarray,
                       w: np.ndarray, n_cams: int, n_pts: int,
                       n_blocks: int, *, pad_to: int = 8) -> BlockLayout:
    """Partition the observation table into per-device blocks with halo slots.

    Dead observations (w == 0) are dropped; every block's arrays are padded
    to the max block size (rounded to ``pad_to``) so the stacked layout is
    rectangular: rank b takes rows [b*cap, (b+1)*cap).
    """
    cam_id = np.asarray(cam_id, np.int64)
    pt_id = np.asarray(pt_id, np.int64)
    w = np.asarray(w, np.float32)
    uv = np.asarray(uv, np.float32)
    alive = w > 0

    part = partition_trajectory(cam_id.astype(np.int32), pt_id.astype(np.int32),
                                alive, n_cams, n_pts, n_blocks)
    cam_block = part.cam_block.astype(np.int64)
    pt_block = part.pt_block.astype(np.int64).copy()
    # orphan points (no alive obs): spread round-robin so padding stays balanced
    dead_pts = pt_block < 0
    pt_block[dead_pts] = np.arange(int(dead_pts.sum())) % n_blocks

    # ---- cameras: contiguous ranges (cam_block is nondecreasing) -----------
    cam_counts = np.bincount(cam_block, minlength=n_blocks)
    cb = _roundup(cam_counts.max(), pad_to)
    cam_starts = np.searchsorted(cam_block, np.arange(n_blocks))
    cam_local = np.arange(n_cams) - cam_starts[cam_block]
    cam_global = np.full(n_blocks * cb, -1, np.int64)
    cam_global[cam_block * cb + cam_local] = np.arange(n_cams)

    # ---- points: per-block rank via stable sort -----------------------------
    p_order = np.argsort(pt_block, kind="stable")
    blk_sorted = pt_block[p_order]
    p_starts = np.searchsorted(blk_sorted, np.arange(n_blocks))
    pt_local = np.empty(n_pts, np.int64)
    pt_local[p_order] = np.arange(n_pts) - p_starts[blk_sorted]
    pt_counts = np.bincount(pt_block, minlength=n_blocks)
    pb = _roundup(pt_counts.max(), pad_to)
    pt_global = np.full(n_blocks * pb, -1, np.int64)
    pt_global[pt_block * pb + pt_local] = np.arange(n_pts)

    # ---- halo exports: points owned by b observed from other blocks --------
    obs_blk = cam_block[cam_id]
    halo_obs = alive & (pt_block[pt_id] != obs_blk)
    if halo_obs.any():
        hp = np.unique(
            pt_block[pt_id[halo_obs]] * np.int64(n_pts) + pt_id[halo_obs])
        h_owner = hp // n_pts
        h_pt = hp % n_pts
    else:
        h_owner = np.zeros(0, np.int64)
        h_pt = np.zeros(0, np.int64)
    h_counts = np.bincount(h_owner, minlength=n_blocks)
    hcap = _roundup(h_counts.max() if h_counts.size else 0, pad_to)
    h_starts = np.searchsorted(h_owner, np.arange(n_blocks))
    h_slot = np.arange(len(h_owner)) - h_starts[h_owner]
    halo_idx = np.zeros(n_blocks * hcap, np.int64)
    halo_mask = np.zeros(n_blocks * hcap, bool)
    halo_idx[h_owner * hcap + h_slot] = pt_local[h_pt]
    halo_mask[h_owner * hcap + h_slot] = True
    # global point -> its halo slot within its owner block (-1 if not exported)
    slot_of_pt = np.full(n_pts, -1, np.int64)
    slot_of_pt[h_pt] = h_slot

    # ---- observations: device = camera's block; sort by (block, pt_ext) ----
    a_cam = cam_id[alive]
    a_pt = pt_id[alive]
    a_uv = uv[alive]
    a_w = w[alive]
    a_blk = cam_block[a_cam]
    local_owned = pt_block[a_pt] == a_blk
    a_ext = np.where(local_owned, pt_local[a_pt],
                     pb + pt_block[a_pt] * hcap + slot_of_pt[a_pt])
    # sort by block, then by extended point index: the solver's point-side
    # segment reductions then take the sorted-scatter fast path
    o_order = np.lexsort((a_ext, a_blk))
    a_cam, a_pt, a_uv, a_w = a_cam[o_order], a_pt[o_order], a_uv[o_order], a_w[o_order]
    a_ext, a_blk = a_ext[o_order], a_blk[o_order]
    o_counts = np.bincount(a_blk, minlength=n_blocks)
    ob = _roundup(o_counts.max() if o_counts.size else 0, pad_to)
    o_starts = np.searchsorted(a_blk, np.arange(n_blocks))
    o_rank = np.arange(len(a_blk)) - o_starts[a_blk]
    pos = a_blk * ob + o_rank

    obs_cam_l = np.zeros(n_blocks * ob, np.int32)
    obs_pt_ext = np.zeros(n_blocks * ob, np.int32)
    obs_uv = np.zeros((n_blocks * ob, 2), np.float32)
    obs_w = np.zeros(n_blocks * ob, np.float32)
    obs_cam_l[pos] = cam_local[a_cam]
    obs_pt_ext[pos] = a_ext
    obs_uv[pos] = a_uv
    obs_w[pos] = a_w

    return BlockLayout(n_blocks, cb, pb, ob, hcap,
                       cam_global, pt_global,
                       obs_cam_l, obs_pt_ext, obs_uv, obs_w,
                       halo_idx.astype(np.int32), halo_mask, part)


def scatter_cams(layout: BlockLayout, *global_arrays):
    """Gather per-camera global arrays into the stacked (n*Cb, ...) layout."""
    out = []
    idx = np.maximum(layout.cam_global, 0)
    valid = layout.cam_global >= 0
    for a in global_arrays:
        a = np.asarray(a)
        loc = a[idx].copy()
        loc[~valid] = 0
        out.append(loc)
    return out


def scatter_pts(layout: BlockLayout, *global_arrays):
    """Gather per-point global arrays into the stacked (n*Pb, ...) layout."""
    out = []
    idx = np.maximum(layout.pt_global, 0)
    valid = layout.pt_global >= 0
    for a in global_arrays:
        a = np.asarray(a)
        loc = a[idx].copy()
        loc[~valid] = 0
        out.append(loc)
    return out


def gather_cams(layout: BlockLayout, n_cams: int, *stacked_arrays):
    """Map stacked (n*Cb, ...) results back to global camera order."""
    valid = layout.cam_global >= 0
    out = []
    for a in stacked_arrays:
        a = np.asarray(a)
        g = np.zeros((n_cams,) + a.shape[1:], a.dtype)
        g[layout.cam_global[valid]] = a[valid]
        out.append(g)
    return out


def gather_pts(layout: BlockLayout, n_pts: int, *stacked_arrays):
    """Map stacked (n*Pb, ...) results back to global point order."""
    valid = layout.pt_global >= 0
    out = []
    for a in stacked_arrays:
        a = np.asarray(a)
        g = np.zeros((n_pts,) + a.shape[1:], a.dtype)
        g[layout.pt_global[valid]] = a[valid]
        out.append(g)
    return out
