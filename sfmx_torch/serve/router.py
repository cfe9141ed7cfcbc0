"""Retrieval-routed map shards (port of ``sfmx.serve.router``).

At multi-floor or building scale one logical map is split into spatial
shards, each resident on its own device, and each query is routed to the
shard that retrieval says contains the place, so serving capacity grows
with devices while every query touches one shard.

  * ``split_localization_map`` cuts a built map into keyframe-contiguous
    shards balanced by landmark count (host numpy, the reference's split bit
    for bit); the parent VLAD vocabulary is shared, so global descriptors
    stay comparable across shards.
  * ``MapShardRouter`` keeps each shard on its device, routes a query batch
    with one GEMM over every shard's keyframe global descriptors, groups
    the queries by winning shard, and localizes each group with one
    ``localize_batch`` call on its shard's device.  No collective is
    needed: with more shards than devices they share devices round-robin.

The reference pads each group to a power of two to bound XLA recompiles;
PyTorch runs eagerly, so a group holds exactly its queries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..localize import retrieve
from ..localize.localize import LocalizationMap, LocalizeResult, localize_batch


def split_localization_map(lmap: LocalizationMap, n_shards: int) -> list[LocalizationMap]:
    """Cut a map into keyframe-contiguous shards balanced by landmark load.

    Each shard keeps its keyframes' rows plus exactly the landmarks those
    keyframes observe (kf_lm re-indexed into the shard-local landmark
    arrays).  Landmarks observed from two shards' keyframes are duplicated
    into both — the serving analog of the BA halo.  The shards lie on the
    map's device.
    """
    cols = lmap.to_numpy()
    C = cols["kf_lm"].shape[0]
    kf_lm, kf_lm_mask = cols["kf_lm"], cols["kf_lm_mask"]
    # balance by per-keyframe landmark load (contiguous ranges: trajectory
    # order == covisibility order, same argument as partition_trajectory)
    load = kf_lm_mask.sum(1).astype(np.float64)
    cum = np.cumsum(load)
    targets = cum[-1] * (np.arange(1, n_shards) / n_shards)
    splits = np.concatenate([[0], np.searchsorted(cum, targets) + 1, [C]])

    X = cols["X"]
    shards = []
    for s, e in zip(splits[:-1], splits[1:]):
        s, e = int(s), int(e)
        ids = np.unique(kf_lm[s:e][kf_lm_mask[s:e]])
        remap = np.zeros(X.shape[0], np.int32)
        remap[ids] = np.arange(len(ids), dtype=np.int32)
        part = {k: cols[k][ids] for k in ("X", "lm_desc", "lm_alive", "lm_bits") if k in cols}
        part.update({k: cols[k][s:e] for k in ("kf_gdesc", "kf_alive", "kf_centers",
                                               "kf_lm_mask")})
        part["kf_lm"] = remap[kf_lm[s:e]]
        shard = LocalizationMap.from_numpy(part, lmap.X.device)
        shards.append(shard._replace(vocab=lmap.vocab))   # shared: scores stay comparable
    return shards


def _to(lmap: LocalizationMap, device) -> LocalizationMap:
    return LocalizationMap(*(None if x is None else x.to(device) for x in lmap))


@dataclasses.dataclass
class MapShardRouter:
    """Device-per-shard serving: route by retrieval, localize on the shard."""

    shards: list                  # LocalizationMap, each on its device
    devices: list                 # torch.device per shard
    router_gdesc: torch.Tensor    # (sum C_i, G) stacked keyframe descriptors, on devices[0]
    router_shard: np.ndarray      # (sum C_i,) owning shard of each router row
    vocab: torch.Tensor | None    # on devices[0]

    @classmethod
    def build(cls, shards: list[LocalizationMap], devices) -> "MapShardRouter":
        devices = [torch.device(d) for d in devices]
        if len(devices) < len(shards):
            # more shards than devices: round-robin (still correct, less
            # memory headroom per device)
            devices = [devices[i % len(devices)] for i in range(len(shards))]
        devices = devices[:len(shards)]
        placed = [_to(s, d) for s, d in zip(shards, devices)]
        g = np.concatenate([s.kf_gdesc.cpu().numpy() for s in shards])
        own = np.concatenate([np.full(s.kf_gdesc.shape[0], i, np.int32)
                              for i, s in enumerate(shards)])
        ka = np.concatenate([s.kf_alive.cpu().numpy() for s in shards])
        g = np.where(ka[:, None], g, 0.0).astype(np.float32)   # dead keyframes never win
        vocab = shards[0].vocab
        return cls(shards=placed, devices=devices,
                   router_gdesc=torch.from_numpy(g).to(devices[0]), router_shard=own,
                   vocab=None if vocab is None else vocab.to(devices[0]))

    def route(self, q_desc: torch.Tensor, q_mask: torch.Tensor) -> np.ndarray:
        """(B,K,D) query descriptors -> (B,) winning shard ids (one GEMM)."""
        dev = self.router_gdesc.device
        q_desc, q_mask = q_desc.to(dev), q_mask.to(dev)
        if self.vocab is not None:
            qg = retrieve.vlad_encode(q_desc, q_mask, self.vocab)
        else:
            qg = torch.sum(torch.where(q_mask[..., None], q_desc, torch.zeros_like(q_desc)),
                           dim=1)
            qg = qg / torch.clamp(torch.linalg.vector_norm(qg, dim=-1, keepdim=True), min=1e-8)
        scores = qg @ self.router_gdesc.T                   # (B, sum C_i)
        return self.router_shard[torch.argmax(scores, dim=-1).cpu().numpy()]

    def localize_batch(self, q_desc, q_uv, q_mask, intr, *,
                       generators: dict | None = None,
                       gumbel: Callable[[int, np.ndarray], torch.Tensor] | None = None,
                       q_bits=None, shard: int | None = None,
                       **localize_kw) -> tuple[LocalizeResult, np.ndarray]:
        """Route, group by shard, localize each group with ONE
        ``localize_batch`` call on its shard's device.

        Every group is issued before any result is read, so the shards'
        devices work at once; the results come back to the host in input
        order.  intr: (7,) shared or (B,7) per-query intrinsics.  The RANSAC
        noise of a group comes from ``gumbel(shard id, query indices)``
        ((n, k_hypotheses, K)) when given, else from ``generators[device]``
        (the default generator where None).  q_bits go to shards that carry
        ``lm_bits``.  ``shard``: every query to that shard, unrouted (a
        warm-up reaches each shard's device so).  Returns (results on the
        host in input order, shard id per query).
        """
        B = q_desc.shape[0]
        shard_of = self.route(q_desc, q_mask) if shard is None else np.full(B, shard)
        intr_b = intr.expand(B, 7) if intr.ndim == 1 else intr
        pending = []   # (query indices, result on its device) per shard group
        for sid in np.unique(shard_of):
            sid = int(sid)
            lmap, dev = self.shards[sid], self.devices[sid]
            idx = np.flatnonzero(shard_of == sid)
            rows = torch.from_numpy(idx).to(q_desc.device)
            take = lambda a: a[rows].to(dev, non_blocking=True)
            kw = dict(localize_kw)
            if gumbel is not None:
                kw["gumbel"] = gumbel(sid, idx).to(dev)
            else:
                kw["generator"] = None if generators is None else generators[dev]
            if q_bits is not None and lmap.lm_bits is not None:
                kw["q_bits"] = take(q_bits)
            res = localize_batch(lmap, take(q_desc), take(q_uv), take(q_mask), take(intr_b), **kw)
            pending.append((idx, res))   # no host read yet: keep the devices busy
        outs = [None] * len(LocalizeResult._fields)
        for idx, res in pending:
            rows = torch.from_numpy(idx)
            for f, x in enumerate(res):
                x = x.cpu()
                if outs[f] is None:
                    outs[f] = torch.empty((B, *x.shape[1:]), dtype=x.dtype)
                outs[f][rows] = x
        return LocalizeResult(*outs), shard_of
