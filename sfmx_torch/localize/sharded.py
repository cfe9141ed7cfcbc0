"""Map-sharded localization: the landmark pool split over a process group
(port of ``sfmx.localize.sharded``).

Queries are replicated (they are small); each rank runs the top-2 match of
the whole query batch against ITS landmark shard (kernel K4,
``kernels/match.match_top2``, on a card), then one all-gather of the
per-shard (best, argbest, second) — 3 numbers per query feature per shard —
merges them in shard order to the exact global top-2.  The winning
landmarks' positions and alive flags come from their owning rank by one
all-reduce of a masked local gather.  Total communication per batch is
O(n_shards * B * K) numbers, independent of the pool size.  The PnP-RANSAC
tail then runs replicated on every rank (per-query work on K
correspondences) with the same noise, so every rank returns the same poses.

Acceptance is ``localize_batch_streaming``'s: Lowe ratio + absolute floor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import cameras
from ..core.masking import round_up
from ..dist.halo import all_gather_cat, all_reduce_sum
from ..kernels.match import match_top2, merge_top2
from .localize import LocalizationMap, LocalizeResult, _noise, _per_query, _pnp_from_matches

TILE_A, TILE_B = 256, 2048      # the query and landmark padding of a shard's K4 call


def shard_localization_map(lmap: LocalizationMap, rank: int, world_size: int,
                           device) -> LocalizationMap:
    """Rank ``rank``'s shard of ``lmap`` on ``device``: its contiguous slice
    of the landmark columns (X, lm_desc, lm_alive, lm_bits), the pool padded
    with dead rows to a multiple of ``world_size`` first, and the keyframe
    columns whole.  Every shard holds P_local = ceil(P / world_size) rows."""
    P = lmap.X.shape[0]
    pad = (-P) % world_size
    pl = (P + pad) // world_size
    sl = slice(rank * pl, (rank + 1) * pl)

    def cut(x):
        if x is None:
            return None
        x = torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])
        return x[sl].to(device)

    return lmap._replace(
        X=cut(lmap.X), lm_desc=cut(lmap.lm_desc), lm_alive=cut(lmap.lm_alive),
        lm_bits=cut(lmap.lm_bits),
        **{k: None if getattr(lmap, k) is None else getattr(lmap, k).to(device)
           for k in ("kf_gdesc", "kf_alive", "kf_centers", "kf_lm", "kf_lm_mask", "vocab")})


def local_top2(q: torch.Tensor, pool: torch.Tensor):
    """One shard's top-2 of q (BK,D) over its pool (Pl,D): (s1, i1, s2),
    each (BK,), i1 in [0, Pl).  Both sides are zero-padded to K4's tiles;
    a pad row that wins is clamped to the last real row, as the
    reference's shard function does."""
    BK, Pl = q.shape[0], pool.shape[0]
    qp = F.pad(q, (0, 0, 0, round_up(max(BK, TILE_A), TILE_A) - BK))
    pp = F.pad(pool, (0, 0, 0, round_up(max(Pl, TILE_B), TILE_B) - Pl))
    s1, i1, s2 = match_top2(qp, pp, tile_a=TILE_A, tile_b=TILE_B)
    return s1[:BK], torch.clamp(i1[:BK], max=Pl - 1), s2[:BK]


def merge_shards(s1, i1, s2, p_local: int):
    """The exact global top-2 from per-shard (n, BK) results, merged in
    shard order by ``match.merge_top2``: the global best; on a tie the lower
    shard; the second is the larger of the winner's second and the other
    shards' bests; the global index ``i1 + d * p_local``.  Returns (s1, i1
    global, s2); the owning shard of a winner is its index // p_local."""
    gi = i1.to(torch.int64) + torch.arange(s1.shape[0], device=s1.device)[:, None] * p_local
    out = (s1[0], gi[0], s2[0])
    for d in range(1, s1.shape[0]):
        out = merge_top2(out, (s1[d], gi[d], s2[d]))
    return out


def sharded_top2(lmap: LocalizationMap, q_desc: torch.Tensor, q_mask: torch.Tensor,
                 group=None):
    """The exact global top-2 of the (B,K,D) queries over the process
    group's sharded pool: this rank's K4 on its shard, one all-gather of
    the shards' (s1, i1, s2) merged in shard order, and the winners'
    positions and alive flags from their owning rank by one all-reduce.
    Returns (s1, global index, s2) (B*K,) and X3 (B*K,3), alive (B*K,),
    the same on every rank."""
    B, K, D = q_desc.shape
    rank = dist.get_rank(group)
    q = torch.where(q_mask[..., None], q_desc, torch.zeros_like(q_desc)).reshape(B * K, D)
    pl = lmap.X.shape[0]
    pool = torch.where(lmap.lm_alive[:, None], lmap.lm_desc, torch.zeros_like(lmap.lm_desc))
    s1, i1, s2 = local_top2(q, pool)
    # one all-gather of the shards' (s1, i1, s2), the index carried as its bits
    parts = all_gather_cat(torch.stack([s1, i1.view(torch.float32), s2])[None], group)
    s1g, ig, s2g = merge_shards(parts[:, 0], parts[:, 1].contiguous().view(torch.int32),
                                parts[:, 2], pl)
    # the winners' positions and alive flags from their owning rank: a
    # masked local gather, summed over ranks (exact: one term is nonzero)
    mine = (ig // pl == rank)[:, None]
    loc = torch.cat([lmap.X[i1.long()], lmap.lm_alive[i1.long()].to(torch.float32)[:, None]],
                    dim=1)
    got = all_reduce_sum(torch.where(mine, loc, torch.zeros_like(loc)), group)
    return s1g, ig, s2g, got[:, :3], got[:, 3] > 0


def localize_batch_sharded(lmap: LocalizationMap, q_desc: torch.Tensor, q_uv: torch.Tensor,
                           q_mask: torch.Tensor, intr: torch.Tensor, *,
                           generator: torch.Generator | None = None,
                           gumbel: torch.Tensor | None = None, k_hypotheses: int = 1024,
                           px_thresh: float = 4.0, ratio: float = 0.85,
                           sim_thresh: float = 0.75, min_inliers: int = 12,
                           pnp_solver: str = "dlt6", group=None):
    """Batch localization against the process group's sharded landmark pool.

    ``lmap`` is this rank's shard (``shard_localization_map``); the queries
    (B,K,D), (B,K,2), (B,K), the intrinsics ((7,) or (B,7)) and the RANSAC
    noise ``gumbel`` (B,k_hypotheses,K) — or a ``generator`` seeded alike on
    every rank — are the same on every rank.  Returns (LocalizeResult,
    (B,K) global landmark index of each query feature's best match), the
    same on every rank."""
    B, K, _ = q_desc.shape
    s1g, ig, s2g, X3, alive = sharded_top2(lmap, q_desc, q_mask, group)
    res = pose_from_top2(s1g, s2g, X3.reshape(B, K, 3), alive.reshape(B, K), q_uv, q_mask, intr,
                         generator=generator, gumbel=gumbel, k_hypotheses=k_hypotheses,
                         px_thresh=px_thresh, ratio=ratio, sim_thresh=sim_thresh,
                         min_inliers=min_inliers, pnp_solver=pnp_solver)
    return res, ig.reshape(B, K)


def pose_from_top2(s1, s2, X3, alive, q_uv, q_mask, intr, *,
                   generator: torch.Generator | None = None, gumbel: torch.Tensor | None = None,
                   k_hypotheses: int = 1024, px_thresh: float = 4.0, ratio: float = 0.85,
                   sim_thresh: float = 0.75, min_inliers: int = 12,
                   pnp_solver: str = "dlt6") -> LocalizeResult:
    """The merged global top-2 (s1, s2 (B*K,), the winners' X3 (B,K,3) and
    alive flags (B,K)) to poses: the ratio test and the absolute floor,
    then batched PnP-RANSAC and the GN refine."""
    B, K = q_mask.shape
    d1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    ok = (d1 < ratio * ratio * d2) & (s1 > sim_thresh)
    corr_ok = ok.reshape(B, K) & alive & q_mask
    intr_b = _per_query(intr, B)
    xn = cameras.pixel_to_normalized(intr_b[:, None, :], q_uv)
    gumbel = _noise(gumbel, generator, B, k_hypotheses, K, q_uv.device)
    return _pnp_from_matches(xn, X3, corr_ok, intr_b, gumbel, px_thresh=px_thresh,
                             min_inliers=min_inliers, pnp_solver=pnp_solver)
