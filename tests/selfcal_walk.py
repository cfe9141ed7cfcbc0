"""The reference's self-calibration beside the port's on one track table:
the 96-frame walk's ``reconstruct`` inputs that ``chip_smoke.py``'s phase 24
saves (``.chip_scratch/selfcal_walk.npz``: keypoints, tracks, pair counts
and the focal guess 5 % high), through ``sfmx``'s ``reconstruct`` and the
port's on the CPU, both with ``refine_intrinsics=("f",)`` on the default
``ReconConfig`` with ``seed`` 0 .. n_seeds - 1 (each package draws its own
RANSAC samples from it).  Prints each package's refined focal against the
true one and the card's.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 tests/selfcal_walk.py [path to the npz [n_seeds]]
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sfmx.recon import incremental as jinc
    from sfmx.recon import tracks as jtracks
    from sfmx_torch.recon import incremental as tinc
    from sfmx_torch.recon.tracks import TrackTable

    path = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / ".chip_scratch" / "selfcal_walk.npz"
    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    z = dict(np.load(path))
    n_tracks = int(z["n_tracks"])
    focal, f_card = float(z["focal"]), float(z["f_card"])
    args = (z["kp_uv"], z["kp_mask"])
    tail = (z["intr"], z["cam_k"])
    counts = (z["pairs"], z["pair_counts"])
    out = {"frames": int(z["kp_uv"].shape[0]), "observations": int(len(z["obs_cam"])),
           "focal_true": focal, "focal_guess": float(z["intr"][0, 0]), "focal_card": f_card}
    for name, mod, table, extra in (
            ("reference", jinc, jtracks.TrackTable(z["obs_cam"], z["obs_feat"], z["obs_track"],
                                                   n_tracks), {}),
            ("port_cpu", tinc, TrackTable(z["obs_cam"], z["obs_feat"], z["obs_track"], n_tracks),
             {"device": "cpu"})):
        out[name] = []
        for seed in range(n_seeds):
            cfg = dataclasses.replace(mod.ReconConfig(), refine_intrinsics=("f",), seed=seed)
            t0 = time.perf_counter()
            scene, stats = mod.reconstruct(*args, table, *tail, cfg, pair_counts=counts, **extra)
            f = float(np.asarray(scene.intr)[0, 0])
            out[name].append({"seed": seed, "focal": round(f, 3), "rel": round(f / focal - 1.0, 5),
                              "init_pair": [int(c) for c in stats["init_pair"]],
                              "registered": stats["n_registered"],
                              "points": stats["n_points"],
                              "wall_s": round(time.perf_counter() - t0, 1)})
            print(json.dumps({name: out[name][-1]}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
