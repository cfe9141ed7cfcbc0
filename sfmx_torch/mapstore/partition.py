"""Covisibility-balanced map partitioning + halo analysis (a copy of
``sfmx.mapstore.partition``: host numpy).

For configs 4-5 (multi-floor / city-block maps) the long axis is the
trajectory: cameras are clustered into contiguous blocks balanced by
OBSERVATION count (not camera count — observation load is what BA
parallelism cares about), each landmark is assigned to the block owning
most of its observations, and observations crossing blocks form the HALO —
the per-iteration communication set whose size is the distributed-BA comm
cost (monitor it; the partitioner minimizes it by cutting at covisibility
minima).

The obs-sharded BA (dist.dist_ba) does not *need* this partitioning to be
correct — it all-reduces full camera/point blocks.  Partitioning is the scale
path: each device holds only its block's points, and only halo landmarks
are exchanged (all-gather of the boundary set).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Partition(NamedTuple):
    cam_block: np.ndarray     # (C,) block id per camera
    pt_block: np.ndarray      # (P,) block id per landmark (-1 = unowned/dead)
    obs_block: np.ndarray     # (O,) block id per observation (= its camera's)
    halo_obs: np.ndarray      # (O,) bool: observation's point lives elsewhere
    n_blocks: int

    def halo_fraction(self) -> float:
        tot = max(int((self.obs_block >= 0).sum()), 1)
        return float(self.halo_obs.sum()) / tot

    def block_obs_counts(self) -> np.ndarray:
        return np.bincount(self.obs_block[self.obs_block >= 0],
                           minlength=self.n_blocks)


def partition_trajectory(obs_cam: np.ndarray, obs_pt: np.ndarray,
                         obs_alive: np.ndarray, n_cams: int, n_pts: int,
                         n_blocks: int, *, balance_iters: int = 3) -> Partition:
    """Contiguous camera-range blocks balanced by observation load.

    Walkthrough trajectories are temporally ordered, so contiguous camera
    ranges are near-optimal covisibility clusters (covisibility decays with
    frame distance); the split points are chosen so each block carries
    ~equal observations.
    """
    alive = obs_alive.astype(bool)
    cam_load = np.bincount(obs_cam[alive], minlength=n_cams).astype(np.float64)
    cum = np.cumsum(cam_load)
    total = cum[-1] if len(cum) else 0.0
    # observation-balanced contiguous splits
    targets = total * (np.arange(1, n_blocks) / n_blocks)
    splits = np.searchsorted(cum, targets)
    cam_block = np.zeros(n_cams, np.int32)
    prev = 0
    for b, s in enumerate(np.append(splits, n_cams)):
        cam_block[prev:s + 1 if b < n_blocks - 1 else n_cams] = b
        prev = s + 1 if b < n_blocks - 1 else n_cams

    # landmark ownership: block with most alive observations of it
    pt_votes = np.zeros((n_pts, n_blocks), np.int32)
    np.add.at(pt_votes, (obs_pt[alive], cam_block[obs_cam[alive]]), 1)
    pt_block = np.where(pt_votes.sum(1) > 0, pt_votes.argmax(1), -1).astype(np.int32)

    obs_block = np.where(alive, cam_block[obs_cam], -1).astype(np.int32)
    halo = alive & (pt_block[obs_pt] != obs_block) & (pt_block[obs_pt] >= 0)
    return Partition(cam_block, pt_block, obs_block, halo, n_blocks)


def reorder_obs_by_block(part: Partition, *arrays):
    """Sort observation arrays by block id (contiguous per-device layout).

    Returns (order, sorted arrays...) — the layout the obs-sharded BA wants
    so each mesh shard holds one block's observations (its halo rows still
    reference remote landmark ids; the all-reduce handles them — with block
    layout those rows are the ONLY cross-shard traffic).
    """
    order = np.argsort(part.obs_block, kind="stable")
    return (order, *[a[order] for a in arrays])
