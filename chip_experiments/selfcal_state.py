#!/usr/bin/env python3
"""The 96-frame walk's self-calibration on the card (S3 and S4 in
ROADMAP.md): ``chip_smoke.py`` phase 24's build captured, the port's joint
pose, point and focal LM (``lm.ba_solve_intrinsics``) traced from the
captured state, and the build over many seeds.

    python3 chip_experiments/selfcal_state.py [--capture] [--state] [--builds] [--out DIR]
    python3 chip_experiments/selfcal_state.py --replay SAMPLES_DIR [--out DIR]

Needs a CUDA card.  With no mode flag it runs all three, in this order:

- ``--capture``: renders the walk as ``chip_smoke.py`` does (its first
  N_BUILD frames), runs ``build_map`` on the card with the focal guess
  FOCAL_GUESS x the true one and ``refine_intrinsics=("f",)`` (phase 24's
  build), and writes to ``DIR`` (default ``.chip_scratch/``)
  ``selfcal_walk.npz`` (the track table and the rest of ``reconstruct``'s
  inputs, as phase 24 saves them) and ``selfcal_card_state.npz`` (the state
  handed to the joint LM: ``NAMES``); prints the seed pair, ``init_med_px``,
  the refined focal and the joint LM's cost trace.
- ``--state``: the joint LM from the captured state on the card and on the
  CPU (``joint_trace``): per iteration the four trial costs, per CG step
  ``rz`` and ``pAp``, the smallest pivot of the camera blocks that the
  preconditioner inverts, and the refined focal.
- ``--builds``: ``reconstruct`` on the captured table on the card from
  ``ReconConfig.seed`` 0 .. N_SEEDS-1, each build's seed pair, its trial
  score and ``init_med_px``, the refined focal and the non-finite entries of
  the joint LM's cost trace; the rate of builds more than 3 % off.
- ``--replay SAMPLES_DIR`` (alone): ``reconstruct`` on the captured table on
  the card from the minimal samples that ``tests/s3_lockstep.py record``
  saved (the reference's draws, ``replay``).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NAMES = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w_valid", "fixed")
KW = dict(params=("f",), iters=25, cg_iters=30, huber_px=4.0)
N_SEEDS = 24                 # --builds: ReconConfig.seed 0 .. N_SEEDS-1
FOCAL_TRUE = 560.0
MISS = 0.03                  # a walk whose focal ends more than 3 % off (the arc's gate)
CARD = "cuda"


def pair_order(pairs, counts, min_init_inliers: int) -> list:
    """The primary component's seed candidates, as ``reconstruct``'s
    ``make_pair_order`` lists them with every camera allowed."""
    prs, pcnt = np.asarray(pairs), np.asarray(counts)
    selp = np.flatnonzero(pcnt >= min_init_inliers)
    selp = selp[np.argsort(-pcnt[selp])]
    if len(selp) > 48:
        selp = selp[np.round(np.linspace(0, len(selp) - 1, 48)).astype(int)]
    return [(int(a), int(b)) for a, b in prs[selp]]


def trial_scores(order, cnt, par, n_cams: int, cfg) -> np.ndarray:
    """``try_seed``'s trial ranking of the candidates (-1 for a failing one)."""
    cnt, par = np.asarray(cnt, np.float64), np.asarray(par, np.float64)
    passing = (cnt >= cfg.min_init_inliers) & (par > cfg.min_parallax_deg) & (par < 60.0)
    mid = np.array([a + b for a, b in order], np.float64) / 2.0
    central = 1.0 - 0.6 * np.abs(mid - n_cams / 2.0) / max(n_cams / 2.0, 1)
    return np.where(passing, cnt * np.minimum(par, 15.0) * central, -1.0)


def cost_summary(costs) -> dict:
    c = np.asarray(costs, np.float64)
    bad = np.flatnonzero(~np.isfinite(c))
    return {"costs": [float(x) for x in c], "non_finite": int(len(bad)),
            "non_finite_at": [int(i) - 1 for i in bad]}   # LM iteration of each entry


def min_pivot(Ud, fixed) -> dict:
    """The smallest Cholesky pivot (f64) of the damped 6x6 camera blocks the
    preconditioner inverts, over the free cameras, and how many of them are
    not positive definite."""
    import torch

    M = Ud.detach().double().cpu()[~torch.as_tensor(np.asarray(fixed, bool))]
    L, info = torch.linalg.cholesky_ex(M)
    ok = info == 0
    piv = torch.diagonal(L[ok], dim1=-2, dim2=-1) ** 2
    return {"min_pivot": float(piv.min()) if len(piv) else None,
            "not_pd": int((~ok).sum())}


def joint_trace(state: dict, device: str) -> dict:
    """The port's ``ba_solve_intrinsics`` (KW) from ``state``, recording per
    LM iteration the four trial costs and the damping, per CG step ``rz``
    and ``pAp`` (the PCG is ``schur.pcg_pair``'s loop, written out here with
    the records; its arithmetic is the same), and the smallest camera-block
    pivot.  Returns those records, the cost trace and the refined focal."""
    import torch

    from sfmx_torch.solvers import lm, schur

    rec = {"trials": [], "lam": [], "rz": [], "pAp": [], "pivot": []}
    fixed = np.asarray(state["fixed"], bool)

    def decide(tc, cost, lam):
        rec["trials"].append([float(x) for x in tc.cpu()])
        rec["lam"].append(float(lam))
        return orig_decide(tc, cost, lam)

    def pcg_k(sk, iters=30, fixed_cam_mask=None):
        rec["pivot"].append(min_pivot(sk.sys.Ud, fixed))
        Minv_c, Minv_k = schur._inv_spd(sk.sys.Ud), schur._inv_spd(sk.Ukk_d)

        def proj(xc, xk):
            return torch.where(fixed_cam_mask[:, None], torch.zeros_like(xc), xc), xk

        def prec(rc, rk):
            return schur._bmv(Minv_c, rc), schur._bmv(Minv_k, rk)

        def dot(a, b):
            return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

        r = proj(sk.sys.b_red, sk.b_red_k)
        x = (torch.zeros_like(r[0]), torch.zeros_like(r[1]))
        z = proj(*prec(*r))
        p = z
        rzs, paps = [], []
        for _ in range(iters):
            Sp = proj(*schur.schur_matvec_k(sk, *p))
            rz = dot(r, z)
            pAp = dot(p, Sp)
            rzs.append(float(rz))
            paps.append(float(pAp))
            alpha = rz / torch.clamp(pAp, min=1e-20)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            r = (r[0] - alpha * Sp[0], r[1] - alpha * Sp[1])
            z = proj(*prec(*r))
            beta = dot(r, z) / torch.clamp(rz, min=1e-20)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
        rec["rz"].append(rzs)
        rec["pAp"].append(paps)
        return x

    args = [torch.as_tensor(state[n], device=device) for n in NAMES]
    orig_decide, orig_pcg = lm.lm_decide, schur.pcg_k
    lm.lm_decide, schur.pcg_k = decide, pcg_k
    try:
        t0 = time.perf_counter()
        _R, _t, _X, intr, costs = lm.ba_solve_intrinsics(*args, **KW)
        wall = time.perf_counter() - t0
    finally:
        lm.lm_decide, schur.pcg_k = orig_decide, orig_pcg
    f = float(intr[0, 0])
    return {"device": device, "focal": f, "rel": f / FOCAL_TRUE - 1.0,
            **cost_summary(costs.cpu().numpy()), "wall_s": wall, **rec}


def first_bad_step(pAp: list, rz: list) -> dict:
    """The first CG step whose pAp is not positive or whose pAp or rz is not
    finite: its index, pAp and rz (and the step before it)."""
    for k, (a, b) in enumerate(zip(pAp, rz)):
        if not (np.isfinite(a) and np.isfinite(b) and a > 0):
            return {"cg_step": k, "pAp": a, "rz": b,
                    "before": {"pAp": pAp[k - 1], "rz": rz[k - 1]} if k else None}
    return {"cg_step": None}


def trace_brief(tr: dict) -> dict:
    """One line of a trace: the cost trace, its non-finite trials by
    iteration, and at each iteration with a non-finite trial the CG's first
    step with a pAp that is not positive (or not finite) and the smallest
    camera pivot."""
    out = {k: tr[k] for k in ("device", "focal", "rel", "costs", "non_finite", "non_finite_at")}
    bad = [i for i, t in enumerate(tr["trials"]) if not np.all(np.isfinite(t))]
    out["iterations_with_a_non_finite_trial"] = [
        {"iteration": i, "trials": tr["trials"][i], "lam": tr["lam"][i] if "lam" in tr else None,
         **first_bad_step(tr["pAp"][i], tr["rz"][i]), **tr["pivot"][i]} for i in bad]
    out["min_pivot_all"] = min(p["min_pivot"] for p in tr["pivot"] if p["min_pivot"] is not None)
    return out


def capture(out_dir: Path) -> None:
    import torch

    import chip_smoke as cs
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.recon import incremental
    from sfmx_torch.solvers import lm
    from tests import smoke_scenes

    dev = torch.device(CARD)
    t0 = time.perf_counter()
    poses = smoke_scenes.loop_walk_poses(cs.N_BAND)[:cs.N_BUILD]
    frames = smoke_scenes.render_parallel(0, poses, cs.W_IMG, cs.H_IMG, cs.FOCAL,
                                          cs.RENDER_WORKERS)
    print(json.dumps({"rendered": len(frames), "s": time.perf_counter() - t0}), flush=True)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon, refine_intrinsics=("f",)))
    guess = cs.INTR.copy()
    guess[:2] *= cs.FOCAL_GUESS
    with cs.recorded(lm, "ba_solve_intrinsics") as joint:
        with cs.recorded(incremental, "reconstruct") as rec:
            scene, _f, _tt, stats, wall, ate = cs.run_build("self-calibration", frames, poses,
                                                            cfg, dev, intr=guess)
    (kp_uv, kp_mask, tt, intr_in, cam_k), rkw = rec[0]["args"][:5], rec[0]["kw"]
    f_est = float(scene.intr[0, 0])
    pairs_w, counts_w = (np.asarray(a) for a in rkw["pair_counts"])
    np.savez(out_dir / "selfcal_walk.npz", kp_uv=kp_uv, kp_mask=kp_mask, obs_cam=tt.obs_cam,
             obs_feat=tt.obs_feat, obs_track=tt.obs_track, n_tracks=tt.n_tracks, intr=intr_in,
             cam_k=cam_k, pairs=pairs_w, pair_counts=counts_w, focal=cs.FOCAL, f_card=f_est)
    j = joint[0]
    np.savez(out_dir / "selfcal_card_state.npz",
             **{n: v.cpu().numpy() for n, v in zip(NAMES, j["args"])})
    _R, _t, _X, _intr, costs = lm.ba_solve_intrinsics(*j["args"], **j["kw"])
    print(json.dumps({"capture": "card", "init_pair": stats["init_pair"],
                      "init_med_px": stats["init_med_px"], "init_pairs": stats["init_pairs"],
                      "focal": f_est, "rel": f_est / cs.FOCAL - 1.0,
                      "registered": int(scene.cam_alive.sum()), "ate_m": ate, "build_s": wall,
                      "joint_kw": {k: v for k, v in j["kw"].items()},
                      "joint_observations": int(len(j["args"][5])),
                      "intrinsics_ba_costs": stats["intrinsics_ba_costs"],
                      **cost_summary(costs.cpu().numpy())}), flush=True)


def state(out_dir: Path) -> None:
    st = dict(np.load(out_dir / "selfcal_card_state.npz"))
    print(json.dumps({"state": "card", "observations": int(len(st["cam_id"])),
                      "focal_in": float(st["intr"][0, 0])}), flush=True)
    for dev in (CARD, "cpu"):
        tr = joint_trace(st, dev)
        with open(out_dir / f"selfcal_trace_{dev}.json", "w") as fh:
            json.dump(tr, fh)
        print(json.dumps({"state": "card", **trace_brief(tr), "wall_s": tr["wall_s"]}),
              flush=True)


def build_one(z: dict, seed: int, device: str, dense: str = "auto") -> dict:
    """``reconstruct`` on the captured table at ``seed``: its seed pair, the
    pair's trial score and rank, ``init_med_px``, the refined focal and the
    joint LM's cost trace."""
    import torch

    from sfmx_torch.recon import incremental
    from sfmx_torch.recon.tracks import TrackTable
    from sfmx_torch.solvers import lm

    tt = TrackTable(z["obs_cam"], z["obs_feat"], z["obs_track"], int(z["n_tracks"]))
    cfg = dataclasses.replace(incremental.ReconConfig(), refine_intrinsics=("f",),
                              dense_ba=dense, seed=seed)
    seen = {}
    orig_batch, orig_joint = incremental._init_pair_batch, lm.ba_solve_intrinsics

    def batch(*a, **k):
        out = orig_batch(*a, **k)
        seen.setdefault("cnt", out[3].cpu().numpy())
        seen.setdefault("par", out[4].cpu().numpy())
        return out

    def joint(*a, **k):
        out = orig_joint(*a, **k)
        seen["costs"] = out[4].cpu().numpy()
        return out

    incremental._init_pair_batch, lm.ba_solve_intrinsics = batch, joint
    try:
        t0 = time.perf_counter()
        scene, st = incremental.reconstruct(
            z["kp_uv"], z["kp_mask"], tt, z["intr"], z["cam_k"], cfg,
            pair_counts=(z["pairs"], z["pair_counts"]), device=torch.device(device))
        wall = time.perf_counter() - t0
    finally:
        incremental._init_pair_batch, lm.ba_solve_intrinsics = orig_batch, orig_joint
    order = pair_order(z["pairs"], z["pair_counts"], cfg.min_init_inliers)
    score = trial_scores(order, seen["cnt"], seen["par"], z["kp_uv"].shape[0], cfg)
    ranked = [order[i] for i in np.argsort(-score) if score[i] > 0]
    a, b = (int(c) for c in st["init_pair"])
    ci = order.index((a, b))
    f = float(scene.intr[0, 0])
    summ = cost_summary(seen["costs"])
    return {"seed": seed, "device": device, "dense_ba": dense, "init_pair": [a, b],
            "trial_rank": ranked.index((a, b)), "trial_score": float(score[ci]),
            "inliers": int(seen["cnt"][ci]), "parallax_deg": float(seen["par"][ci]),
            "init_med_px": st["init_med_px"], "init_pairs": st["init_pairs"],
            "focal": f, "rel": f / FOCAL_TRUE - 1.0, "miss": abs(f / FOCAL_TRUE - 1.0) > MISS,
            "registered": st["n_registered"], "points": st["n_points"],
            "cost0": summ["costs"][0], "cost_min": float(np.nanmin(seen["costs"])),
            "non_finite": summ["non_finite"], "non_finite_at": summ["non_finite_at"],
            "wall_s": round(wall, 2)}


def builds(out_dir: Path) -> None:
    import torch

    torch.set_num_threads(8)
    z = dict(np.load(out_dir / "selfcal_walk.npz"))
    rows = []
    for seed in range(N_SEEDS):
        rows.append(build_one(z, seed, CARD))
        print(json.dumps(rows[-1]), flush=True)
    misses = [r["seed"] for r in rows if r["miss"]]
    print(json.dumps({"builds": "card", "seeds": N_SEEDS, "misses_over_3pct": len(misses),
                      "miss_seeds": misses,
                      "focal_min": min(r["focal"] for r in rows),
                      "focal_max": max(r["focal"] for r in rows),
                      "non_finite_builds": sum(r["non_finite"] > 0 for r in rows)}), flush=True)


def replay(out_dir: Path, samples_dir: Path) -> None:
    """``reconstruct`` on the card on the reference's RANSAC draws: every
    minimal sample that the port drew on the CPU in lockstep with the
    reference (``tests/s3_lockstep.py record``), replayed in its call order
    in place of ``ransac.sample_minimal``, resection in one call a round as
    there.  Prints each seed's build beside the CPU's pair and focal."""
    import torch

    from sfmx_torch.recon import incremental
    from sfmx_torch.solvers import ransac

    z = dict(np.load(out_dir / "selfcal_walk.npz"))
    orig_sm, orig_chunk = ransac.sample_minimal, incremental._RESECT_CHUNK
    for path in sorted(samples_dir.glob("samples_seed*.npz")):
        rec = np.load(path)
        calls = [rec[k] for k in sorted(k for k in rec.files if k.startswith("call"))]
        left = list(reversed(calls))

        def sample_minimal(gumbel, mask, sample_size):
            want = left.pop()
            assert want.shape == (*gumbel.shape[:-1], sample_size), (want.shape, gumbel.shape)
            return torch.as_tensor(want.astype(np.int64), device=gumbel.device)

        ransac.sample_minimal, incremental._RESECT_CHUNK = sample_minimal, 1 << 30
        try:
            row = build_one(z, int(path.stem[len("samples_seed"):]), CARD)
        finally:
            ransac.sample_minimal, incremental._RESECT_CHUNK = orig_sm, orig_chunk
        print(json.dumps({"replay": "reference draws", **row, "calls": len(calls),
                          "calls_left": len(left), "cpu_init_pair": rec["init_pair"].tolist(),
                          "cpu_focal": float(rec["focal"])}), flush=True)


def main() -> int:
    import torch

    import sfmx_torch  # noqa: F401  (sets the TF32 flags)

    assert torch.cuda.is_available(), "needs a CUDA card"
    argv = sys.argv[1:]
    out_dir = Path(argv[argv.index("--out") + 1]) if "--out" in argv else ROOT / ".chip_scratch"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if "--replay" in argv:
        replay(out_dir, Path(argv[argv.index("--replay") + 1]))
        print(smi)
        return 0
    modes = [m for m in ("--capture", "--state", "--builds") if m in argv]
    modes = modes or ["--capture", "--state", "--builds"]
    if "--capture" in modes:
        capture(out_dir)
    if "--state" in modes:
        state(out_dir)
    if "--builds" in modes:
        builds(out_dir)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
