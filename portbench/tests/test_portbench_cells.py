"""Each cell at a toy size on the CPU through the port's plain paths: the
harness's whole run (set-up, window, check) comes out correct; with the
timed path broken underneath (an answer altered where it is produced: the
pose, K4's match, the descriptors), or with the control in the program's
place, it comes out not correct.  A run on the card repeats the control at
the cell's own size."""
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import guard, harness  # noqa: E402

TOY = {"image": {"width": 320, "height": 240, "focal": 280.0},
       "features": {"max_keypoints": 256},
       "map": {"keyframes": 8, "distractor_rooms": 2, "landmarks": 70000},
       "pool": 6, "service": {"max_batch": 4},
       # at a quarter of the cell's pixels and keypoints, with ~150 inliers a
       # pose, a returned pose lies further from its optimum and from the
       # reference's (medians up to 0.09 and 13 mm over five seeds on the
       # CPU), so the toy holds those two numbers to 0.25 and 50 mm; the
       # cell's own limits hold otherwise
       "check": {"watch_every": 1, "sample": 6, "min_checked": 4,
                 "limits": {"image": {"pose_gap_m": 0.05},
                            "features": {"pose_cost_excess": 0.25}}},
       "traffic": {"clients": 8, "warmup_s": 0.5}}
CELLS = ("serve-building-images", "serve-building-features")


def run_toy(workload, seed=2 ** 33 + 7):
    import torch

    spec = harness.load_cell(ROOT, workload)
    out = harness.run_cell(spec, seed, 3.0, False, torch.device("cpu"), time.time(), ROOT,
                           overrides=TOY)
    return out, harness.correct(out["numbers"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(workload):
    out, ok = run_toy(workload)
    assert ok, out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"serve_rps", "setup_s"}
    assert guard.forbidden_loaded() == [], "the run loaded JAX or the JAX package"


def _shift_pose(monkeypatch):
    import sfmx_torch.localize.localize as loc

    orig = loc._pnp_from_matches

    def broken(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(t=res.t + 0.3, center=res.center - 0.3)

    monkeypatch.setattr(loc, "_pnp_from_matches", broken)


def _shift_matches(monkeypatch):
    import sfmx_torch.kernels.match as mt

    orig = mt.match_top2

    def broken(a, b, **kw):
        s1, i1, s2 = orig(a, b, **kw)
        return s1, (i1 + 1) % b.shape[0], s2

    monkeypatch.setattr(mt, "match_top2", broken)


def _noisy_descriptors(monkeypatch):
    import torch

    import sfmx_torch.kernels.features as ft

    orig = ft.detect_and_describe

    def broken(*a, **kw):
        f = orig(*a, **kw)
        d = f.desc + 0.05 * torch.randn(f.desc.shape, generator=torch.Generator().manual_seed(0))
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return f._replace(desc=torch.where(f.kp.mask[..., None], d, torch.zeros_like(d)))

    monkeypatch.setattr(ft, "detect_and_describe", broken)


@pytest.mark.parametrize("fault,workload", [
    (_shift_pose, "serve-building-images"), (_shift_pose, "serve-building-features"),
    (_shift_matches, "serve-building-images"), (_shift_matches, "serve-building-features"),
    (_noisy_descriptors, "serve-building-images"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    out, ok = run_toy(workload)
    assert not ok, out["numbers"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_cpu(workload):
    import torch

    from portbench import control

    spec = harness.load_cell(ROOT, workload)
    res = control.control_numbers(spec, 2 ** 32 + 5, torch.device("cpu"), 6, overrides=TOY)
    assert not res["correct"], res


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from portbench import control

    spec = harness.load_cell(ROOT, workload)
    for seed in (11, 12, 13):
        res = control.control_numbers(spec, seed, torch.device("cuda", 0), 24)
        assert not res["correct"], res


def test_the_plain_extraction_copy_equals_the_ports_plain_path():
    import torch

    from portbench.ref import extract as rx
    from portbench.scenes import room
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import _extract_raw

    poses = room.walk_poses(3)
    imgs = room.render_room_torch(room.RoomTexture(seed=9), [R for R, _, _ in poses],
                                  [e for _, _, e in poses], 160, 120, 140.0, torch.device("cpu"))
    ref = rx.extract(torch.from_numpy(imgs), max_keypoints=256, threshold=1e-7, n_octaves=2)
    cfg = PipelineConfig()
    import dataclasses
    cfg = dataclasses.replace(cfg, features=dataclasses.replace(cfg.features, max_keypoints=256))
    port = _extract_raw(imgs, cfg, torch.device("cpu"))
    assert torch.equal(ref.mask, port.kp.mask)
    assert np.abs((ref.uv - port.kp.uv).numpy()).max() == 0.0
    assert np.abs((ref.desc - port.desc).numpy()).max() < 1e-6
