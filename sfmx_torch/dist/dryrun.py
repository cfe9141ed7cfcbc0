"""The multi-device dry run: every multi-device path once, on tiny shapes,
each result asserted finite (port of ``__graft_entry__.dryrun_multichip``).

  1. a point-sharded (block + halo) BA solve (``block_ba.ba_solve_blocked``),
     with 1/n-sized per-rank camera and point state;
  2. a point-sharded joint-intrinsics solve (distributed self-calibration);
  3. an observation-sharded BA step (``dist_ba.make_ba_step``);
  4. data-parallel extraction (each rank a slice of the batch: K1-K3 on a
     card) gathered to every rank, then pair matching (K5 on a card);
  5. map-sharded localization (K4 on each rank's landmark shard).

    python -m sfmx_torch.dist.dryrun [--world-size N] [--device cuda|cpu]

runs it in N spawned ranks (NCCL for ``cuda``: one card per rank; gloo for
``cpu``; ``--device cuda:0 --backend gloo`` puts every gloo rank on card 0).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import _build, features
from ..kernels.matching import match_pairs_float_auto
from ..localize.localize import LocalizationMap
from ..localize.sharded import localize_batch_sharded, shard_localization_map
from ..solvers.ransac import gumbel_noise
from . import block_ba, dist_ba, mesh
from .halo import all_gather_cat


def extract_data_parallel(images: np.ndarray, device, group=None, **kw) -> features.Features:
    """Data-parallel extraction: (B,H,W) images, the same on every rank;
    rank r extracts its contiguous slice (B padded with blank frames to a
    multiple of the world size) on ``device`` and every rank gets the whole
    batch's features.  ``kw`` go to ``features.detect_and_describe``."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    B = images.shape[0]
    imgs = mesh.pad_to_multiple(np.asarray(images, np.float32), n)
    m = imgs.shape[0] // n
    f = features.detect_and_describe(
        torch.from_numpy(np.ascontiguousarray(imgs[rank * m:(rank + 1) * m])).to(device), **kw)

    def cat(x):
        if x.dtype == torch.bool:
            return all_gather_cat(x.to(torch.uint8), group)[:B].bool()
        return all_gather_cat(x, group)[:B]

    return features.Features(features.Keypoints(*(cat(x) for x in f.kp)), cat(f.desc),
                             cat(f.desc_bits))


def example_map(P: int, C: int, D: int, Kc: int, seed: int, device) -> LocalizationMap:
    """A random unit-descriptor map (``__graft_entry__._example_map``)."""
    rng = np.random.default_rng(seed)
    lm_desc = rng.standard_normal((P, D)).astype(np.float32)
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    kf_g = rng.standard_normal((C, D)).astype(np.float32)
    kf_g /= np.linalg.norm(kf_g, axis=1, keepdims=True)
    return LocalizationMap.from_numpy(dict(
        X=rng.uniform(-3, 3, (P, 3)).astype(np.float32), lm_desc=lm_desc,
        lm_alive=np.ones(P, bool), kf_gdesc=kf_g, kf_alive=np.ones(C, bool),
        kf_centers=rng.uniform(-2, 2, (C, 3)).astype(np.float32),
        kf_lm=rng.integers(0, P, size=(C, Kc)).astype(np.int32),
        kf_lm_mask=np.ones((C, Kc), bool)), device)


def sharded_case(n: int):
    """The map-sharded localization case of a world of n: a random map of
    64*n landmarks on the CPU, two queries of 64 features (numpy) and their
    RANSAC noise (64 hypotheses), drawn on the CPU from seeds, so a world
    on cards, one on CPUs and a single process all see the same draw."""
    lmap = example_map(64 * n, 8, 128, 32, 3, "cpu")
    rng = np.random.default_rng(4)
    Kq = 64
    qd = rng.standard_normal((2, Kq, 128)).astype(np.float32)
    qd /= np.linalg.norm(qd, axis=-1, keepdims=True)
    quv = rng.uniform(0, 320, (2, Kq, 2)).astype(np.float32)
    intr = np.asarray([280.0, 280.0, 160.0, 120.0, 0, 0, 0], np.float32)
    g = gumbel_noise((2, 64, Kq), device="cpu", generator=torch.Generator().manual_seed(2))
    return lmap, qd, quv, np.ones((2, Kq), bool), intr, g


def obs_problem(n: int, rng: np.random.Generator):
    """The observation-sharded BA's problem of a world of n: 8 cameras 4 m
    from 4n points, each point seen by four distinct cameras (16n
    observations, as the reference's dry run has; its 16n random (camera,
    point) pairs over 64 points leave most points with one view or none, a
    system so underdetermined that one ulp of the input moves the cost
    after a step by ~1e-3, and no two devices agree), 0.5 px of noise.
    Returns (X, t, cam, pt, uv), drawing X, t and the cameras from rng."""
    C, P = 8, 4 * n
    X = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-0.2, 0.2, (C, 2)), np.full((C, 1), 4.0)], 1)
    cam = np.concatenate([rng.permutation(C)[:4] for _ in range(P)])
    pt = np.repeat(np.arange(P), 4)
    Xc = X[pt] + t[cam]
    uv = (Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0]) + _pixel_noise(9, len(pt))
    return X, t, cam, pt, uv


def _pixel_noise(seed: int, n: int) -> np.ndarray:
    """0.5 px of seeded Gaussian noise on n observations (from a generator
    of its own, so the block problem's draws stay the reference's): from
    the exact truth a solve's costs are rounding, ~1e-14, which no two
    devices reproduce; from the noise they are the solve's."""
    return 0.5 * np.random.default_rng(seed).standard_normal((n, 2))


def _finite(name: str, *xs) -> None:
    for x in xs:
        a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert np.isfinite(a).all(), f"{name}: non-finite result"


def dryrun(rank: int, world_size: int, device: torch.device, out_path: str | None = None) -> dict:
    """Every multi-device path once on this rank; returns (and with
    ``out_path`` rank 0 writes, as JSON) what each produced and the kernel
    launches of the run (``_build.LAUNCHES``, counted from 0)."""
    n = world_size
    out = {}
    _build.LAUNCHES.reset()
    # ---- point-sharded (block + halo) BA: the scale path ------------------
    rng = np.random.default_rng(7)
    C, P = 4 * n, 40 * n
    O = 24 * C
    X = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-1, 1, (C, 2)), np.full((C, 1), 15.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam = np.repeat(np.arange(C, dtype=np.int32), O // C)
    lo = (cam.astype(np.int64) * (P - 20) // C).astype(np.int64)
    pt = (lo + rng.integers(0, 20, O)).astype(np.int32)
    Xc = X[pt] + t[cam]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0])
          + _pixel_noise(8, O)).astype(np.float32)
    intr = np.asarray([[100.0, 100.0, 32.0, 24.0, 0, 0, 0]], np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    args = (intr, np.zeros(C, np.int32), R, t, X, cam, pt, uv, np.ones(O, np.float32), fixed)
    _, _, _, costs, stats = block_ba.ba_solve_blocked(*args, device=device, iters=2, cg_iters=5)
    _finite("block BA", costs)
    assert stats["pts_per_device"] < P or n == 1, "point state not sharded"
    out["block_ba"] = {"costs": costs.tolist(), **stats}

    # ---- point-sharded JOINT intrinsics BA (distributed self-calibration) --
    _, _, _, intr_k, costs_k, _ = block_ba.ba_solve_blocked_intrinsics(
        *args, device=device, params=("f",), iters=2, cg_iters=5)
    _finite("block BA-k", costs_k, intr_k)
    assert tuple(intr_k.shape) == intr.shape
    out["block_ba_k"] = {"costs": costs_k.tolist(), "focal": float(intr_k[0, 0])}

    # ---- observation-sharded BA -------------------------------------------
    rng = np.random.default_rng(0)
    T = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    Xo, to, cam, pt, uv = obs_problem(n, rng)
    C, O = to.shape[0], cam.shape[0]
    fixed = np.zeros(C, bool)
    fixed[0] = True
    step = dist_ba.make_ba_step(iters=2, cg_iters=5)
    R1, t1, X1, costs = step(T(intr), T(np.zeros(C), torch.int64),
                             T(np.tile(np.eye(3), (C, 1, 1))), T(to), T(Xo),
                             T(cam, torch.int64), T(pt, torch.int64), T(uv), T(np.ones(O)),
                             T(fixed, torch.bool))
    _finite("obs-sharded BA", costs, R1, t1, X1)
    out["obs_ba"] = {"costs": costs.tolist()}

    # ---- data-parallel extraction + matching -------------------------------
    imgs = rng.random((n, 48, 64)).astype(np.float32)
    feats = extract_data_parallel(imgs, device, max_keypoints=16, threshold=1e-9)
    pairs = np.asarray([[i, (i + 1) % n] for i in range(n)], np.int32)
    res = match_pairs_float_auto(feats.desc, feats.kp.mask, T(pairs, torch.int64))
    _finite("DP extraction", feats.desc)
    assert tuple(res.idx.shape) == (n, 16)
    out["dp"] = {"keypoints": int(feats.kp.mask.sum()), "matches": int(res.valid.sum())}

    # ---- map-sharded localization (the landmark pool over the ranks) --------
    lmap, qd, quv, qm, intr_q, g = sharded_case(n)
    shard = shard_localization_map(lmap, rank, n, device)
    sres, idx = localize_batch_sharded(shard, T(qd), T(quv), T(qm, torch.bool), T(intr_q),
                                       gumbel=g.to(device), k_hypotheses=g.shape[1])
    _finite("map-sharded localization", sres.t, sres.R)
    assert tuple(sres.t.shape) == (2, 3)
    out["sharded"] = {"t": sres.t.tolist(), "idx_max": int(idx.max())}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["launches"] = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
    if out_path is not None and rank == 0:
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world-size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (card <rank> per rank), cuda:<i> (every rank on card i) or cpu")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--out", default=None, help="rank 0 writes its results here (JSON)")
    a = p.parse_args(argv)
    mesh.spawn(dryrun, a.world_size, a.out, device=a.device, backend=a.backend)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
