"""F17 (ROADMAP.md queue 3): the README's config 4 build on the card, with
the track table its ``reconstruct`` receives saved.

Runs ``sfmx_torch.run_configs.config2_scale`` (the 2+ streaming CLI build,
the same walk and build as config 4-build's) on a corridor walk at one seed
with ``recon.incremental.reconstruct`` wrapped: its inputs (keypoints, the
track table, intrinsics, the per-pair verified counts, the ReconConfig) go to an
``.npz`` the CPU can feed to both packages' ``reconstruct``
(``tests/f15_lockstep.py``'s loader reads it), and the build's line is
printed with the card's name and power limit.

Run from the repository root on the card (~1 min for 1,024 frames):
    python3 chip_experiments/f17_inputs.py OUT.npz [frames [seed [scene [device]]]]
"""
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from sfmx_torch import run_configs as rc
    from sfmx_torch.recon import incremental

    out = Path(sys.argv[1])
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    scene = sys.argv[4] if len(sys.argv) > 4 else "corridor"
    device = sys.argv[5] if len(sys.argv) > 5 else "cuda"
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
           if device.startswith("cuda") else device)
    orig = incremental.reconstruct
    saved = []

    def recording(kp_uv, kp_mask, tt, intr, cam_k, cfg, callbacks=None, pair_counts=None, *,
                  device):
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out, kp_uv=kp_uv, kp_mask=kp_mask, obs_cam=tt.obs_cam, obs_feat=tt.obs_feat,
            obs_track=tt.obs_track, n_tracks=tt.n_tracks, intr=intr, cam_k=cam_k,
            pairs=np.asarray(pair_counts[0]), pair_counts=np.asarray(pair_counts[1]),
            seed=cfg.seed, recon=json.dumps(dataclasses.asdict(cfg)))
        saved.append(str(out))
        return orig(kp_uv, kp_mask, tt, intr, cam_k, cfg, callbacks, pair_counts, device=device)

    incremental.reconstruct = recording
    try:
        with tempfile.TemporaryDirectory(prefix="sfmx_f17_") as root:
            line = rc.config2_scale(device, root, frames=frames, scene=scene, seed=seed)
    finally:
        incremental.reconstruct = orig
    poses, _render = rc.walk(frames, scene, 4)
    with np.load(out) as z:
        extra = dict(z)
    np.savez_compressed(out, **extra, eyes=np.stack([e for (_, _, e) in poses]).astype(np.float32))
    line.pop("map_path", None)
    print(json.dumps({"f17_inputs": saved, "card": smi, "torch": torch.__version__, **line}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
