#!/usr/bin/env python3
"""Why the 96-frame walk self-calibrates on the CPU and not on the card:
the joint pose, point and focal LM (``lm.ba_solve_intrinsics``) run on the
card and on the CPU from the same starting state, for two states:

- ``cpu``: the state the port's CPU ``reconstruct`` hands the joint solve
  on the walk's track table (``.chip_scratch/selfcal_cpu_state.npz``);
- ``card``: the state the card's ``reconstruct`` hands it on the same table
  (``.chip_scratch/selfcal_walk.npz``, which ``chip_smoke.py``'s phase 24
  writes), captured in this run.

    python3 chip_experiments/selfcal_state.py [--builds]

Needs a CUDA card.  Prints, for each state and device, the refined focal
against the truth (560 px, guess 588) and the LM's cost trace.  With
``--builds`` it runs instead the whole ``reconstruct`` on the same table on
the card (dense BA on ``"auto"``, and the planes path only) and on the
host's CPU from seed 0, and on the card from seeds 1 .. N_SEEDS-1, and
prints each build's seed pair, points, observations and refined focal.
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
N_SEEDS = 6                  # --builds: the card's builds from ReconConfig.seed 0 .. N_SEEDS-1


def solve(state: dict, device: str) -> dict:
    import torch

    from sfmx_torch.solvers import lm

    args = [torch.as_tensor(state[n], device=device) for n in NAMES]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _R, _t, _X, intr, costs = lm.ba_solve_intrinsics(*args, **KW)
    f = float(intr[0, 0])
    return {"device": device, "focal": round(f, 3), "rel": round(f / 560.0 - 1.0, 5),
            "costs": [round(float(c), 6) for c in costs[:4]] + [round(float(costs[-1]), 6)],
            "wall_s": round(time.perf_counter() - t0, 3)}


def card_state() -> dict:
    import torch

    from sfmx_torch.recon import incremental
    from sfmx_torch.recon.tracks import TrackTable
    from sfmx_torch.solvers import lm

    z = dict(np.load(ROOT / ".chip_scratch" / "selfcal_walk.npz"))
    tt = TrackTable(z["obs_cam"], z["obs_feat"], z["obs_track"], int(z["n_tracks"]))
    cfg = dataclasses.replace(incremental.ReconConfig(), refine_intrinsics=("f",))
    got = {}
    orig = lm.ba_solve_intrinsics

    def capture(*a, **k):
        got.update({n: v.cpu().numpy() for n, v in zip(NAMES, a)})
        return orig(*a, **k)

    lm.ba_solve_intrinsics = capture
    try:
        scene, _stats = incremental.reconstruct(
            z["kp_uv"], z["kp_mask"], tt, z["intr"], z["cam_k"], cfg,
            pair_counts=(z["pairs"], z["pair_counts"]), device=torch.device("cuda"))
    finally:
        lm.ba_solve_intrinsics = orig
    print(json.dumps({"card reconstruct focal": float(scene.intr[0, 0])}), flush=True)
    return got


def builds() -> None:
    import torch

    from sfmx_torch.recon import incremental
    from sfmx_torch.recon.tracks import TrackTable

    torch.set_num_threads(8)
    z = dict(np.load(ROOT / ".chip_scratch" / "selfcal_walk.npz"))
    tt = TrackTable(z["obs_cam"], z["obs_feat"], z["obs_track"], int(z["n_tracks"]))
    runs = [("cuda", "auto", 0), ("cuda", "off", 0), ("cpu", "auto", 0)]
    runs += [("cuda", "auto", seed) for seed in range(1, N_SEEDS)]
    for device, dense, seed in runs:
        cfg = dataclasses.replace(incremental.ReconConfig(), refine_intrinsics=("f",),
                                  dense_ba=dense, seed=seed)
        t0 = time.perf_counter()
        scene, st = incremental.reconstruct(
            z["kp_uv"], z["kp_mask"], tt, z["intr"], z["cam_k"], cfg,
            pair_counts=(z["pairs"], z["pair_counts"]), device=torch.device(device))
        print(json.dumps({"device": device, "dense_ba": dense, "seed": seed,
                          "focal": float(scene.intr[0, 0]),
                          "points": st["n_points"], "observations": int(scene.obs_alive.sum()),
                          "init_pair": st["init_pair"], "rounds": st["n_rounds"],
                          "ba_calls": st["ba_calls"], "wall_s": round(time.perf_counter() - t0, 1)}),
              flush=True)


def main() -> int:
    import torch

    import sfmx_torch  # noqa: F401  (sets the TF32 flags)

    assert torch.cuda.is_available(), "needs a CUDA card"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if "--builds" in sys.argv[1:]:
        builds()
        print(smi)
        return 0
    states = {"cpu": dict(np.load(ROOT / ".chip_scratch" / "selfcal_cpu_state.npz")),
              "card": card_state()}
    for name, st in states.items():
        d = st["intr"]
        print(json.dumps({"state": name, "observations": int(len(st["cam_id"])),
                          "focal_in": float(d[0, 0])}), flush=True)
        for dev in ("cuda", "cpu"):
            print(json.dumps({"state": name, **solve(st, dev)}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
