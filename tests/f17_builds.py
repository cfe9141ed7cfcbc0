"""F17 (ROADMAP.md queue 3): the card's 1,024-frame corridor build replayed
on the CPU from its saved ``reconstruct`` inputs
(``chip_experiments/f17_inputs.py``), through the reference's
``reconstruct``, the port's, and the port's with F8's repair switched off
in this process only (the line of ``sfmx_torch/recon/incremental.py`` that
kills a shared track the fusion's similarity does not map onto itself,
removed from a copy of the module's source that this script loads; the
reference keeps such tracks).  Each build at each seed: registered
cameras, components (with the fusion's outcome) and the ATE of the
registered centres after a similarity, against the saved rendered eyes.

Run from the repository root (the 1,024-frame replay takes minutes a
build on the CPU):
    JAX_PLATFORMS=cpu python3 tests/f17_builds.py FILE.npz [seeds, e.g. 0-4] [ref,port,port_no_f8]
"""
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

F8_LINE = ("        X_alive[np.flatnonzero(shared_t)[~reg.inliers[:int(shared_t.sum())]]] = False\n")


def load(path: str) -> dict:
    d = dict(np.load(path))
    d["n_tracks"] = int(d["n_tracks"])
    d["recon"] = json.loads(str(d["recon"])) if "recon" in d else {}
    return d


def ate(centers, eyes, registered) -> float:
    """ATE of the registered centres after a similarity onto the eyes (the
    port's ``umeyama.ate_rmse`` on the CPU)."""
    import torch

    from sfmx_torch.solvers import umeyama

    T = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)
    return float(umeyama.ate_rmse(T(centers, torch.float32), T(eyes, torch.float32),
                                  T(registered, torch.bool))[0])


def port_without_f8():
    """The port's incremental module with F8's repair removed, loaded from a
    copy of its source under another name."""
    import sfmx_torch.recon.incremental as inc

    src = Path(inc.__file__).read_text()
    assert src.count(F8_LINE) == 1, "F8's line moved; update F8_LINE"
    mod = types.ModuleType("sfmx_torch.recon._incremental_no_f8")
    mod.__package__ = "sfmx_torch.recon"
    mod.__file__ = inc.__file__
    sys.modules[mod.__name__] = mod            # dataclasses look their module up
    exec(compile(src.replace(F8_LINE, ""), inc.__file__, "exec"), mod.__dict__)
    return mod


def build(d: dict, which: str, seed: int) -> dict:
    kw = {k: v for k, v in d["recon"].items() if k != "seed"}
    if which == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfmx.recon import incremental as inc
        from sfmx.recon.tracks import TrackTable

        extra = {}
    else:
        import sfmx_torch.recon.incremental as inc
        from sfmx_torch.recon.tracks import TrackTable

        if which == "port_no_f8":
            inc = port_without_f8()
        extra = {"device": "cpu"}
    tt = TrackTable(d["obs_cam"], d["obs_feat"], d["obs_track"], d["n_tracks"])
    t0 = time.time()
    scene, stats = inc.reconstruct(d["kp_uv"], d["kp_mask"], tt, d["intr"], d["cam_k"],
                                   inc.ReconConfig(**{**kw, "seed": seed}),
                                   pair_counts=(d["pairs"], d["pair_counts"]), **extra)
    reg = np.asarray(scene.cam_alive)
    R, t = np.asarray(scene.cam_R), np.asarray(scene.cam_t)
    c = -np.einsum("cji,cj->ci", R, t)
    return {"build": which, "seed": seed, "registered": int(reg.sum()),
            "ate_m": ate(c, d["eyes"], reg), "components": stats.get("components"),
            "final_med_px": stats.get("final_med_px"), "wall_s": round(time.time() - t0, 1)}


def main() -> int:
    d = load(sys.argv[1])
    lo, hi = (int(x) for x in (sys.argv[2] if len(sys.argv) > 2 else "0-4").split("-"))
    which = (sys.argv[3] if len(sys.argv) > 3 else "ref,port,port_no_f8").split(",")
    for seed in range(lo, hi + 1):
        for w in which:
            print(json.dumps(build(d, w, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
