"""Secondary components on the CPU: the reference's two-cluster world
(``tests/test_multicomponent.py``), whose shared boundary cloud is big
enough for a verified similarity but below the resection gate, through the
port's ``reconstruct`` and the reference's on the same track table.

Tolerances, and why: the two packages draw different RANSAC samples
(``jax.random`` against a ``torch.Generator``), so the builds are compared
by the reference test's gates on both sides (one seed stalls at <= 10
cameras; with components all 16 register, component 1 verified with >= 8
inliers, ATE < 0.1) and by their structure: the same number of components,
component 1 fusing the same 8 cameras, camera centers of the two maps
within 0.05 after a similarity alignment (both sit at the noise-free
optimum of a world ~12 units across).  One case departs from the reference
on purpose (F8 in ROADMAP.md): a false track, which bends the reference's
fusion and which the port kills before its fusion BA as an outlier of the
verified similarity.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching
from sfmx.recon import incremental as jinc
from sfmx.recon import tracks
from sfmx_torch.recon import incremental as tinc
from sfmx_torch.recon.tracks import TrackTable
from sfmx_torch.solvers import umeyama as tum
from tests.test_multicomponent import _features, _two_cluster_world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cluster_build():
    pts, Rs, ts, intr, px, visible, centers = _two_cluster_world()
    rng = np.random.default_rng(1)
    uv, desc, mask = _features(px, visible, rng)
    C, K, _ = uv.shape
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = matching.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    jtt = tracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), C, K)
    tt = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    return uv, mask, jtt, tt, intr, centers


CFG = tinc.ReconConfig(min_resection_inliers=25, min_init_inliers=25, ransac_hypotheses=512)


def _recon(cluster_build, **kw):
    uv, mask, _, tt, intr, centers = cluster_build
    C = uv.shape[0]
    return tinc.reconstruct(uv, mask, tt, intr[None], np.zeros(C, np.int32),
                            dataclasses.replace(CFG, **kw), device="cpu")


def _ref(cluster_build, **kw):
    uv, mask, jtt, _, intr, _ = cluster_build
    cfg = jinc.ReconConfig(min_resection_inliers=25, min_init_inliers=25,
                           ransac_hypotheses=512, **kw)
    return jinc.reconstruct(uv, mask, jtt, intr[None], np.zeros(uv.shape[0], np.int32), cfg)


@pytest.fixture(scope="module")
def multi(cluster_build):
    return _recon(cluster_build, max_components=3), _ref(cluster_build, max_components=3)


def test_single_seed_stalls(cluster_build):
    """With components off the bridge is uncrossable and one cluster stays
    unregistered, in both packages."""
    scene, stats = _recon(cluster_build, max_components=1)
    assert stats["n_registered"] <= 10
    assert stats["components"] == [{"component": 0, "registered": stats["n_registered"]}]
    _, jstats = _ref(cluster_build, max_components=1)
    assert jstats["n_registered"] <= 10


def test_multicomponent_recovers_coverage(cluster_build, multi):
    (scene, stats), _ = multi
    centers = cluster_build[-1]
    assert stats["n_registered"] == 16, stats["components"]
    comp1 = [c for c in stats["components"] if c.get("component") == 1]
    assert comp1 and "fail" not in comp1[0], stats["components"]
    assert comp1[0]["reg_inliers"] >= 8
    rmse, _ = tum.ate_rmse(scene.centers, torch.from_numpy(centers.astype(np.float32)),
                           scene.cam_alive)
    assert float(rmse) < 0.1, float(rmse)
    assert stats["final_med_px"] < 1.0
    assert set(comp1[0]) == {"component", "new_cams", "new_points", "reg_inliers",
                             "shared_tracks", "shared_cams", "med_px"}


def test_multicomponent_matches_reference(cluster_build, multi):
    (scene, stats), (jscene, jstats) = multi
    centers = cluster_build[-1]
    assert jstats["n_registered"] == stats["n_registered"] == 16
    rmse, _ = tum.ate_rmse(torch.from_numpy(np.array(jscene.centers)),
                           torch.from_numpy(centers.astype(np.float32)),
                           torch.from_numpy(np.array(jscene.cam_alive)))
    assert float(rmse) < 0.1
    assert len(stats["components"]) == len(jstats["components"])
    for got, ref in zip(stats["components"], jstats["components"]):
        assert set(got) == set(ref) and ("fail" in got) == ("fail" in ref)
    got1, ref1 = stats["components"][1], jstats["components"][1]
    assert got1["new_cams"] == ref1["new_cams"] == 8
    rmse, _ = tum.ate_rmse(scene.centers, torch.from_numpy(np.array(jscene.centers)),
                           scene.cam_alive)
    assert float(rmse) < 0.05
    # the fusion BA ran three anneal stages of 25 LM iterations without
    # pruning, then the primary's loop resumed over all cameras
    iters = [c[1] for c in stats["ba_call_s"]]
    assert any(iters[i:i + 3] == [25, 25, 25] for i in range(len(iters) - 2)), iters
    assert stats["component_loop_s"]["ba"] <= stats["component_loop_s"]["wall"]


def test_false_track_does_not_bend_the_fusion(cluster_build):
    """F8: one track that joins a point of each cluster (what one false
    match does) is alive in both components with two different points; the
    fused map keeps the primary's, so the other arc's observations of it
    fuse with hundreds of px of error.  The port kills the shared tracks
    that the similarity's RANSAC leaves out before the fusion BA (they come
    back only if they re-triangulate in every view); the reference keeps
    them, and their Huber tail bends its noise-free map past its own ATE
    gate."""
    uv, mask, jtt, _, intr, centers = cluster_build
    starts, ends = jtt.track_slices()
    cams = [jtt.obs_cam[s:e] for s, e in zip(starts, ends)]
    ta = next(i for i, c in enumerate(cams) if len(c) >= 6 and (c < 8).all())
    tb = next(i for i, c in enumerate(cams) if len(c) >= 6 and (c >= 8).all())
    trk = jtt.obs_track.copy()
    trk[trk == ta] = tb
    o = np.argsort(trk, kind="stable")
    jtt2 = tracks.TrackTable(jtt.obs_cam[o], jtt.obs_feat[o], trk[o], jtt.n_tracks)
    C = uv.shape[0]
    scene, stats = tinc.reconstruct(uv, mask, TrackTable(*jtt2), intr[None],
                                    np.zeros(C, np.int32), CFG, device="cpu")
    gt = torch.from_numpy(centers.astype(np.float32))
    assert stats["n_registered"] == 16 and "fail" not in stats["components"][1]
    assert float(tum.ate_rmse(scene.centers, gt, scene.cam_alive)[0]) < 0.1
    jscene, jstats = _ref((uv, mask, jtt2, None, intr, centers), max_components=3)
    jate = tum.ate_rmse(torch.from_numpy(np.array(jscene.centers)), gt,
                        torch.from_numpy(np.array(jscene.cam_alive)))[0]
    assert jstats["n_registered"] == 16 and float(jate) > 0.1
