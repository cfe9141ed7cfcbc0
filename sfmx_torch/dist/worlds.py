"""Rank functions of the multi-card runs: the multi-device paths at full
width, each rank on its own card (``chip_smoke.py --cards 4``).

A world is spawned once (``mesh.spawn(world, n, in_dir, phases)``); rank r
runs the named phases in order on its device.  Phase ``p`` reads the inputs
the parent wrote once to ``<in_dir>/<p>.npz`` (every rank reads the same
file) and writes ``<in_dir>/<p>.w<n>.rank<r>.npz``: its results, the kernel
launches of its main run (``_build.LAUNCHES`` counted from 0) and its
timings.  A wall is host time between two barriers with the device
synchronized; on the CPU it times the plain versions, not a card.

  collectives   all_reduce and all_gather_into_tensor at the sizes given:
                ms and bus bandwidth (nccl-tests' definition), and a small
                seeded sum and gather for their values
  extract       data-parallel extraction (``dryrun.extract_data_parallel``)
  sharded       map-sharded localization (``localize_batch_sharded``: K4 on
                this rank's landmark shard, one all-gather, one all-reduce)
  block_ba      the point-sharded BA (``block_ba.ba_solve_blocked``), its
                layout timed apart; optionally the same solve twice, the
                joint-intrinsics solve and the checkpoint resume
  obs_ba        the observation-sharded BA (``dist_ba.make_ba_step``)
  dryrun        the dry run (``dryrun.dryrun``: every path once, tiny shapes)
"""
from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import _build, features
from ..kernels.segment_sum import segment_plan, segment_sum
from ..localize.localize import LocalizationMap
from ..localize.sharded import (local_top2, localize_batch_sharded, shard_localization_map,
                                sharded_top2)
from ..solvers.ransac import gumbel_noise
from . import block_ba, dist_ba, dryrun, mesh
from .halo import all_gather_cat, all_reduce_sum, ring_reduce_scatter

SEGSUM = ("piece_sum",)          # csrc/segment_sum.cu's kernel
BA_NAMES = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")


def _load(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def digest(*arrays) -> str:
    """sha256 of the arrays' bytes: equal digests are equal bits."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(_np(a))
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(fn(), its wall in s): the ranks joined by a barrier and the device
    synchronized on both sides."""
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    dist.barrier()
    return out, wall


def collective_ms(fn, dev, reps: int = 20) -> float:
    """Time of one call of a collective ``fn`` in ms: ``reps`` calls back to
    back between one pair of CUDA events (the host clock on the CPU), after
    two warm calls and a barrier, so the ranks' arrival skew is paid once
    (as nccl-tests time)."""
    fn()
    fn()
    _sync(dev)
    dist.barrier()
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_device_ms(fn, dev, keys: tuple, reps: int = 5) -> float:
    """Device time per call of the kernels whose names hold one of ``keys``
    (torch.profiler's traced durations, summed over a call's launches);
    NaN on the CPU, where no kernel runs."""
    if dev.type != "cuda":
        return float("nan")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for _ in range(3):      # now and then a trace comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and any(k in e.name for k in keys)]
        if us:
            return sum(us) / 1e3 / reps
    raise RuntimeError(f"the profiler recorded no kernel named like {keys}")


def _launches() -> dict:
    return {k: v for k, v in _build.LAUNCHES.counts.items() if v}


def _counted(fn, dev):
    """(fn(), its wall, the launches of that run counted from 0)."""
    _sync(dev)
    _build.LAUNCHES.reset()
    out, wall = timed(fn, dev)
    return out, wall, _launches()


# ---------------------------------------------------------------------------
# Phases: (rank, n, dev, inputs) -> results to save
# ---------------------------------------------------------------------------


def collectives(rank: int, n: int, dev, z: dict) -> dict:
    """all_reduce and all_gather_into_tensor at each of ``sizes_mb`` (the
    gathered buffer's size for the all-gather), ``reps`` calls back to back
    (``collective_ms``): ms a call and bus bandwidth, algorithm bandwidth times
    2(n-1)/n for the all-reduce and (n-1)/n for the all-gather.  Also the
    sum and the gather of this rank's row of the seeded ``x``, and whether
    a sum of small integers came out exact."""
    out = {}
    reps = int(z["reps"])
    for mb in z["sizes_mb"]:
        numel = int(mb * 2 ** 20) // 4 // n * n
        x = torch.full((numel,), float(rank + 1), device=dev)
        exact = all_reduce_sum(x)
        out[f"ar_exact_{mb:g}"] = bool(torch.all(exact == n * (n + 1) / 2))
        y = torch.zeros(numel, device=dev)
        ar = collective_ms(lambda: dist.all_reduce(y), dev, reps)
        part = torch.zeros(numel // n, device=dev)
        ag = collective_ms(lambda: all_gather_cat(part), dev, reps)
        nbytes = numel * 4
        out[f"ar_ms_{mb:g}"] = ar
        out[f"ag_ms_{mb:g}"] = ag
        out[f"ar_busbw_{mb:g}"] = nbytes / (ar * 1e-3) * 2 * (n - 1) / n / 1e9
        out[f"ag_busbw_{mb:g}"] = nbytes / (ag * 1e-3) * (n - 1) / n / 1e9
    x = torch.as_tensor(z["x"][rank], device=dev)
    out["sum"] = all_reduce_sum(x)
    out["gather"] = all_gather_cat(x)
    return out


def feature_kw(z: dict) -> dict:
    """``detect_and_describe``'s keywords from a phase's inputs."""
    return dict(cfg=features.ScaleSpaceConfig(sigma_levels=tuple(int(s) for s in z["sigma"])),
                max_keypoints=int(z["max_keypoints"]), threshold=float(z["threshold"]),
                n_octaves=int(z["n_octaves"]))


def extract(rank: int, n: int, dev, z: dict) -> dict:
    """Data-parallel extraction of ``frames``: the gathered features and the
    digest of this rank's own slice of them, the launches of one run, and
    the median wall of ``reps`` runs."""
    frames, kw = z["frames"], feature_kw(z)
    run = lambda: dryrun.extract_data_parallel(frames, dev, **kw)
    run()                                                  # kernel loads
    f, _, launches = _counted(run, dev)
    walls = [timed(run, dev)[1] for _ in range(int(z["reps"]))]
    m = -(-frames.shape[0] // n)
    own = slice(rank * m, (rank + 1) * m)
    return dict(desc=f.desc, uv=f.kp.uv, mask=f.kp.mask,
                digest=digest(f.desc, f.kp.uv, f.kp.mask),
                own_digest=digest(f.desc[own], f.kp.uv[own], f.kp.mask[own]),
                wall_s=float(np.median(walls)), walls_s=np.asarray(walls),
                launches=json.dumps(launches))


def localization_map(z: dict) -> LocalizationMap:
    """The map the parent wrote (its ``map_*`` columns), on the CPU."""
    return LocalizationMap.from_numpy({k[4:]: v for k, v in z.items() if k.startswith("map_")},
                                      "cpu")


def query_noise(z: dict, dev) -> torch.Tensor:
    """The RANSAC noise of the batch: ``gumbel`` where given, else drawn on
    the CPU from ``noise_seed`` (the same draw on every rank and in the
    parent, without writing (B, k_hyp, K) floats to a file)."""
    if "gumbel" in z:
        return torch.as_tensor(z["gumbel"], device=dev)
    B, K = z["q_mask"].shape
    g = gumbel_noise((B, int(z["k_hyp"]), K), device="cpu",
                     generator=torch.Generator().manual_seed(int(z["noise_seed"])))
    return g.to(dev)


def sharded(rank: int, n: int, dev, z: dict) -> dict:
    """One batch through ``localize_batch_sharded`` against this rank's
    shard of the map: the poses and global indices, the merged top-2
    fields, the launches and wall of that run; K4's device time on this
    card; the all-gather and the all-reduce of the batch timed alone."""
    shard = shard_localization_map(localization_map(z), rank, n, dev)
    T = lambda k: torch.as_tensor(z[k], device=dev)
    qd, quv, qm, intr = T("q_desc"), T("q_uv"), T("q_mask"), T("intr")
    g = query_noise(z, dev)
    kw = dict(k_hypotheses=int(z["k_hyp"]), px_thresh=float(z["px_thresh"]),
              sim_thresh=float(z["sim_thresh"]), min_inliers=int(z["min_inliers"]))
    run = lambda: localize_batch_sharded(shard, qd, quv, qm, intr, gumbel=g, **kw)
    run()                                                  # kernel load, first collectives
    (res, idx), wall, launches = _counted(run, dev)
    s1, ig, s2, X3, alive = sharded_top2(shard, qd, qm)
    B, K, D = qd.shape
    q = torch.where(qm[..., None], qd, torch.zeros_like(qd)).reshape(B * K, D)
    pool = torch.where(shard.lm_alive[:, None], shard.lm_desc, torch.zeros_like(shard.lm_desc))
    k4_ms = kernel_device_ms(lambda: local_top2(q, pool), dev, ("match_top2", "merge_splits"))
    part = torch.zeros((1, 3, B * K), device=dev)
    loc = torch.zeros((B * K, 4), device=dev)
    return dict(**{f"res_{k}": v for k, v in res._asdict().items()}, idx=idx, s1=s1, ig=ig,
                s2=s2, X3=X3, alive=alive, p_local=shard.X.shape[0], wall_s=wall,
                launches=json.dumps(launches), k4_ms=k4_ms,
                ag_ms=collective_ms(lambda: all_gather_cat(part), dev),
                ag_bytes=n * part.numel() * 4,
                ar_ms=collective_ms(lambda: all_reduce_sum(loc), dev), ar_bytes=loc.numel() * 4)


def _ba_args(z: dict) -> list:
    return [z[k] for k in BA_NAMES]


def block_ba_phase(rank: int, n: int, dev, z: dict) -> dict:
    """``ba_solve_blocked`` on the problem (``iters`` x ``cg_iters``): its
    layout built and timed apart (every rank builds the whole layout from
    the global arrays), one warm iteration, then the timed solve with its
    launches.  ``twice``: the same solve again, bit for bit or not;
    ``k_iters`` > 0: the joint-intrinsics solve of focal; ``ckpt_every`` >
    0: the solve checkpointed under ``<ckpt_dir>/w<n>`` (which must not
    hold a checkpoint yet), uninterrupted and stopped after its first chunk
    then resumed.  Also the bytes and times of one CG
    step's reduce-scatter, all-gather and three scalar all-reduces, and
    the fixed-order segment sum's device time on this rank's camera and
    point sums."""
    args = _ba_args(z)
    it, cg = int(z["iters"]), int(z["cg_iters"])
    C, P = args[2].shape[0], args[4].shape[0]
    t0 = time.perf_counter()
    layout = block_ba._layout(None, args[5], args[6], args[7], args[8], C, P, None)
    layout_s = time.perf_counter() - t0
    solve = lambda iters: block_ba.ba_solve_blocked(*args, device=dev, layout=layout,
                                                    iters=iters, cg_iters=cg)
    solve(1)                                               # kernel load, first collectives
    (R, t, X, costs, stats), wall, launches = _counted(lambda: solve(it), dev)
    out = dict(R=R, t=t, X=X, costs=costs, wall_s=wall, layout_s=layout_s,
               stats=json.dumps(stats), launches=json.dumps(launches))
    if bool(z["twice"]):
        (R2, t2, X2, c2, _), out["wall2_s"] = timed(lambda: solve(it), dev)
        out["repeat_equal"] = digest(R, t, X, costs) == digest(R2, t2, X2, c2)
    if int(z["k_iters"]):
        joint = lambda iters: block_ba.ba_solve_blocked_intrinsics(
            *args, device=dev, layout=layout, params=("f",), iters=iters, cg_iters=cg)
        joint(1)                                           # warm, as the solve above
        (_, _, _, intr_k, costs_k, _), out["k_wall_s"] = timed(
            lambda: joint(int(z["k_iters"])), dev)
        out.update(k_intr=intr_k, k_costs=costs_k)
    every = int(z["ckpt_every"])
    if every:
        root = Path(str(z["ckpt_dir"])) / f"w{n}"        # holds no checkpoint yet
        root.mkdir(parents=True, exist_ok=True)
        ck = dict(device=dev, layout=layout, cg_iters=cg, ckpt_every=every)
        Ra, ta, Xa, ca, _ = block_ba.ba_solve_blocked(*args, iters=it,
                                                      ckpt_path=root / "a.ckpt.npz", **ck)
        block_ba.ba_solve_blocked(*args, iters=every, ckpt_path=root / "b.ckpt.npz", **ck)
        Rb, tb, Xb, cb, _ = block_ba.ba_solve_blocked(*args, iters=it,
                                                      ckpt_path=root / "b.ckpt.npz", **ck)
        out.update(ck_costs=ca, ck_resumed_costs=cb,
                   ck_equal=digest(Ra, ta, Xa, ca[-1:]) == digest(Rb, tb, Xb, cb[-1:]))
    # one CG step's collectives (block_ba._Shard): a reduce-scatter of the
    # (n*Hcap,3) halo partials, an all-gather of (Hcap,3), three dots
    hcap = layout.hcap
    rs_in, ag_in = torch.zeros((n * hcap, 3), device=dev), torch.zeros((hcap, 3), device=dev)
    s = torch.zeros((), device=dev)
    out.update(hcap=hcap, rs_bytes=rs_in.numel() * 4, ag_bytes=n * ag_in.numel() * 4,
               rs_ms=collective_ms(lambda: ring_reduce_scatter(rs_in), dev),
               ag_ms=collective_ms(lambda: all_gather_cat(ag_in), dev),
               dots_ms=collective_ms(lambda: [dist.all_reduce(s) for _ in range(3)], dev))
    # the segment sums of this rank's block: camera (Ob,36), points (Ob,12)
    cam_l, pt_ext = block_ba._blocks(rank, n, dev, (layout.obs_cam_l, layout.obs_pt_ext))
    ob = cam_l.shape[0]
    gen = torch.Generator().manual_seed(rank)
    vc = torch.randn((ob, 36), generator=gen).to(dev)
    vp = torch.randn((ob, 12), generator=gen).to(dev)
    cplan = segment_plan(cam_l, layout.cb)
    pplan = segment_plan(pt_ext, layout.pb + n * hcap)
    out.update(obs_block=ob,
               segsum_cam_ms=kernel_device_ms(lambda: segment_sum(vc, cplan), dev, SEGSUM),
               segsum_pt_ms=kernel_device_ms(lambda: segment_sum(vp, pplan), dev, SEGSUM))
    return out


def obs_ba(rank: int, n: int, dev, z: dict) -> dict:
    """``dist_ba.make_ba_step`` on the problem, its table padded with dead
    rows to a multiple of the world size: one warm iteration, then the
    timed solve with its launches; and one CG step's two all-reduces
    ((P,3) and (C,6)) timed alone."""
    args = _ba_args(z)
    for i in (5, 6, 7, 8):
        args[i] = mesh.pad_to_multiple(args[i], n)
    T = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in args]
    for i in (1, 5, 6):
        T[i] = T[i].long()
    it, cg = int(z["iters"]), int(z["cg_iters"])
    dist_ba.make_ba_step(iters=1, cg_iters=cg)(*T)          # kernel load, first collectives
    (R, t, X, costs), wall, launches = _counted(
        lambda: dist_ba.make_ba_step(iters=it, cg_iters=cg)(*T), dev)
    C, P = T[2].shape[0], T[4].shape[0]
    yp, zc = torch.zeros((P, 3), device=dev), torch.zeros((C, 6), device=dev)
    return dict(R=R, t=t, X=X, costs=costs, wall_s=wall, launches=json.dumps(launches),
                ar_bytes=(yp.numel() + zc.numel()) * 4,
                ar_ms=collective_ms(lambda: (all_reduce_sum(yp), all_reduce_sum(zc)), dev))


def dryrun_phase(rank: int, n: int, dev, z: dict) -> dict:
    """``dryrun.dryrun`` on this rank: its results as JSON."""
    return dict(json=json.dumps(dryrun.dryrun(rank, n, dev)))


PHASES = {"collectives": collectives, "extract": extract, "sharded": sharded,
          "block_ba": block_ba_phase, "obs_ba": obs_ba, "dryrun": dryrun_phase}


def result_path(in_dir, phase: str, n: int, rank: int) -> Path:
    return Path(in_dir) / f"{phase}.w{n}.rank{rank}.npz"


def world(rank: int, n: int, dev, in_dir: str, phases: tuple) -> None:
    """Run ``phases`` in order on this rank (a ``mesh.spawn`` target)."""
    for p in phases:
        path = Path(in_dir) / f"{p}.npz"
        out = PHASES[p](rank, n, dev, _load(path) if path.exists() else {})
        np.savez(result_path(in_dir, p, n, rank), **{k: _np(v) for k, v in out.items()})


def load_results(in_dir, phase: str, n: int) -> list[dict]:
    """Every rank's results of ``phase`` in the world of ``n``."""
    return [_load(result_path(in_dir, phase, n, r)) for r in range(n)]

