"""Determinism gates on the port (mirror of tests/test_determinism.py):
fixed inputs and fixed draws reproduce the map, the extraction and the
localization result bit-identically, here on the CPU, each run twice in
one process; wall-clock instrumentation (``TIMING_KEYS``) is the only
permitted difference.

What holds bit-identical on the card, and what only within a tolerance:

- bit-identical by design: K1-K5 and K9/K10 (each output element summed in
  a fixed order, no atomics), so extraction and matching; K6-K8 on BA's
  dense path (fixed-order sums, no atomics) when no observation overflows
  the dense slots and the RANSAC draws come from a generator seeded alike
  (``chip_smoke.py`` phase 17 runs the same dense solve twice, phase 21 a
  checkpointed solve against an uninterrupted one);
- within a tolerance only: the planes path of BA and the dense path's
  overflow chain, whose ``index_add_`` on CUDA accumulates with
  floating-point atomics in an order that changes from run to run, so two
  runs differ in their last bits, and the incremental build can amplify
  that (S1 in ROADMAP.md: the seed pair and the track count moved under a
  1e-5 change of K1).  ``chip_smoke.py`` phase 29 builds the 96-frame map
  twice through the CLI, prints which arrays differ and by how much, and
  holds both builds to the map-quality gates.
"""
import numpy as np
import pytest
import torch

from sfmx_torch.kernels import features, matching
from sfmx_torch.localize import build_localization_map, localize_query
from sfmx_torch.recon import tracks
from sfmx_torch.recon.incremental import ReconConfig, reconstruct
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)
TIMING_KEYS = {"phase_s", "ba_total_s", "ba_iters_per_s", "ba_call_s", "component_loop_s"}
SCENE_COLUMNS = ("cam_R", "cam_t", "cam_alive", "X", "X_alive",
                 "obs_cam", "obs_pt", "obs_uv", "obs_alive")


def _case():
    rng = np.random.default_rng(7)
    sc = make_scene(n_cams=6, n_points=150, noise_px=0.3, seed=3)
    uv, desc, mask, _ = scene_features(sc, rng, noise=0.05)
    C = uv.shape[0]
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = matching.match_pairs_float(torch.from_numpy(desc), torch.from_numpy(mask), pairs)
    tt = tracks.build_tracks(pairs, res.idx.numpy(), res.valid.numpy(), C, uv.shape[1])
    return sc, uv, desc, mask, tt


def _build(cfg: ReconConfig):
    sc, uv, _, mask, tt = _case()
    return reconstruct(uv, mask, tt, sc.intrinsics[None].astype(np.float32),
                       np.zeros(uv.shape[0], np.int32), cfg, device="cpu")


@pytest.mark.parametrize("dense_ba", ["auto", "on"])
def test_reconstruction_bit_identical(dense_ba):
    cfg = ReconConfig(ba_every=3, dense_ba=dense_ba, dense_ba_min_obs=1)
    s1, st1 = _build(cfg)
    s2, st2 = _build(cfg)
    # wall-clock instrumentation is the only permitted difference
    assert ({k: v for k, v in st1.items() if k not in TIMING_KEYS}
            == {k: v for k, v in st2.items() if k not in TIMING_KEYS})
    assert st1["n_registered"] == 6
    for name in SCENE_COLUMNS:
        assert torch.equal(getattr(s1, name), getattr(s2, name)), f"scene.{name}"


def test_extraction_bit_identical(rng):
    img = torch.from_numpy(rng.random((2, 96, 128)).astype(np.float32))
    f1 = features.detect_and_describe(img, max_keypoints=64, threshold=1e-7)
    f2 = features.detect_and_describe(img, max_keypoints=64, threshold=1e-7)
    assert torch.equal(f1.desc, f2.desc) and torch.equal(f1.desc_bits, f2.desc_bits)
    assert torch.equal(f1.kp.uv, f2.kp.uv) and torch.equal(f1.kp.mask, f2.kp.mask)


def test_localization_bit_identical():
    scene, _ = _build(ReconConfig(ba_every=3))
    sc, uv, desc, mask, tt = _case()
    cols = scene.to_numpy()
    # build_localization_map twice: the vocabulary's k-means uses a fixed seed
    m1 = build_localization_map(cols, desc, tt.obs_feat, "cpu")
    m2 = build_localization_map(cols, desc, tt.obs_feat, "cpu")
    assert torch.equal(m1.lm_desc, m2.lm_desc) and torch.equal(m1.kf_gdesc, m2.kf_gdesc)

    intr = torch.as_tensor(sc.intrinsics, dtype=torch.float32)
    q = (torch.from_numpy(desc[2]), torch.from_numpy(uv[2]), torch.from_numpy(mask[2]))
    r1 = localize_query(m1, *q, intr, generator=torch.Generator().manual_seed(5))
    r2 = localize_query(m1, *q, intr, generator=torch.Generator().manual_seed(5))
    assert torch.equal(r1.R, r2.R) and torch.equal(r1.t, r2.t)
    assert int(r1.n_inliers) == int(r2.n_inliers) >= 12
