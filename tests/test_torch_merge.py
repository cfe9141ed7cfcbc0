"""Multi-session merge on the CPU: ``sfmx_torch.recon.merge`` against
``sfmx.recon.merge``.  Two overlapping sessions of the reference's test
world (``tests/test_merge.py``) are merged by each package: the reference's
sessions through both packages with the reference's draws injected edge by
edge, and the port's own sessions (its ``reconstruct`` on the same track
tables) through the port.

Tolerances, and why:
- ``landmark_descriptors``, ``transform_scene_inplace`` and the fusion
  (union-find over the verified pairs): the same host numpy, exact;
- registration with the same draws: the same inliers, the similarity
  within 1e-5 (``test_torch_register``);
- the joint BA (planes path, 20 LM iterations): LM amplifies rounding, so
  the first cost within 1e-4 relative, the final cost within 2 % and the
  merged camera centers within 1e-3 of the reference's (``test_torch_ba``'s
  tolerances); the reference test's gates on both sides (14 cameras, the
  cost falls, ATE < 0.1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching
from sfmx.recon import merge as jmerge
from sfmx.recon import tracks
from sfmx_torch.recon import incremental as tinc
from sfmx_torch.recon import merge as tmerge
from sfmx_torch.recon.tracks import TrackTable
from sfmx_torch.solvers import umeyama as tum
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features
from tests.test_merge import _session
from tests.test_torch_register import jax_draws, to_port_session

torch.set_num_threads(2)


def _port_session(sc, cam_range, base_desc_seed=99):
    """``tests/test_merge._session`` with the port's ``reconstruct``."""
    uv, desc, mask, _ = scene_features(sc, np.random.default_rng(base_desc_seed), noise=0.04)
    lo, hi = cam_range
    uv, desc, mask = uv[lo:hi], desc[lo:hi], mask[lo:hi]
    C = hi - lo
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = matching.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    jtt = tracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), C, uv.shape[1])
    tt = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    scene, _ = tinc.reconstruct(uv, mask, tt, sc.intrinsics[None].astype(np.float32),
                                np.zeros(C, np.int32), tinc.ReconConfig(), device="cpu")
    return scene, desc, uv, mask, tt.obs_feat


@pytest.fixture(scope="module")
def sessions():
    sc = make_scene(n_cams=12, n_points=300, noise_px=0.3, seed=5, arc_deg=150.0)
    rng = np.random.default_rng(0)
    ref = (_session(sc, (0, 7), rng), _session(sc, (5, 12), rng))
    port = (_port_session(sc, (0, 7)), _port_session(sc, (5, 12)))
    return sc, ref, port


def _gt(sc):
    return torch.from_numpy(np.concatenate([sc.centers[0:7], sc.centers[5:12]]).astype(np.float32))


def _edge_draws(seed, n):
    """merge_scenes' keys: ``key, sk = split(key)`` per session pair, each
    edge's attempts then drawn from its sk."""
    key, keys = jax.random.PRNGKey(seed), {}
    for i in range(n):
        for j in range(i + 1, n):
            key, keys[(i, j)] = jax.random.split(key)
    return lambda i, j: jax_draws(keys[(i, j)])


def test_landmark_descriptors_and_transform_match_reference(sessions):
    _, (s1, _), _ = sessions
    p1 = to_port_session(s1)
    np.testing.assert_array_equal(tmerge.landmark_descriptors(p1[0], p1[1], p1[4]),
                                  jmerge.landmark_descriptors(s1[0], s1[1], s1[4]))
    rng = np.random.default_rng(4)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    args = (np.array(s1[0].cam_R), np.array(s1[0].cam_t), np.array(s1[0].X), 1.7, R,
            np.array([0.3, -1.0, 2.0]))
    for a, b in zip(tmerge.transform_scene_inplace(*args), jmerge.transform_scene_inplace(*args)):
        np.testing.assert_array_equal(a, b)


def test_register_pair_recovers_transform(sessions):
    _, (s1, s2), _ = sessions
    d1 = jmerge.landmark_descriptors(s1[0], s1[1], s1[4])
    d2 = jmerge.landmark_descriptors(s2[0], s2[1], s2[4])
    args = (np.array(s1[0].X), d1, np.array(s1[0].X_alive),
            np.array(s2[0].X), d2, np.array(s2[0].X_alive))
    # the reference hands its key to RANSAC without a split
    s, R, t, pairs, inl = tmerge.register_pair(
        *args, device="cpu",
        noise=lambda shape: np.array(jax.random.gumbel(jax.random.PRNGKey(0), shape)))
    assert inl.sum() >= 20
    X2t = s * (args[3] @ R.T) + t
    err = np.linalg.norm(X2t[pairs[inl, 1]] - args[0][pairs[inl, 0]], axis=1)
    assert np.median(err) < 0.05
    sr, Rr, tr, pr, ir = jmerge.register_pair(*args)
    np.testing.assert_array_equal(pairs, pr)
    np.testing.assert_array_equal(inl, np.asarray(ir))
    assert abs(s / float(sr) - 1.0) < 1e-5
    np.testing.assert_allclose(R, np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(tr), atol=1e-5)


def test_merge_scenes_end_to_end(sessions):
    """The reference test on the port's own sessions."""
    sc, _, port = sessions
    merged, stats = tmerge.merge_scenes(list(port))
    assert stats["n_cameras"] == 14
    assert stats["joint_ba_cost"][1] <= stats["joint_ba_cost"][0]
    rmse, _ = tum.ate_rmse(merged.centers, _gt(sc), merged.cam_alive)
    assert float(rmse) < 0.1, f"merged ATE {float(rmse)}"
    assert merged.X.device.type == "cpu" and merged.obs_pt.dtype == torch.int32
    assert stats["edges"][0]["pair"] == (0, 1) and stats["tree"] == [(0, 1)]


def test_merge_scenes_matches_reference(sessions):
    """The reference's sessions through both packages, the reference's
    draws injected edge by edge: the same registration graph and fusion,
    the same joint BA within the LM tolerances."""
    sc, ref, _ = sessions
    jm, jstats = jmerge.merge_scenes(list(ref))
    tm, tstats = tmerge.merge_scenes([to_port_session(s) for s in ref],
                                     noise=_edge_draws(0, len(ref)))
    for k in ("n_sessions", "pair_inliers", "edges", "tree", "n_cameras", "n_points"):
        assert tstats[k] == jstats[k], k
    for f in ("cam_k", "cam_alive", "X_alive", "obs_cam", "obs_pt", "obs_uv", "obs_alive",
              "intr"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), f)
    c0, c1 = tstats["joint_ba_cost"]
    r0, r1 = jstats["joint_ba_cost"]
    assert abs(c0 / r0 - 1.0) < 1e-4 and abs(c1 / r1 - 1.0) < 0.02
    assert np.abs(tm.centers.numpy() - np.asarray(jm.centers)).max() < 1e-3
    rmse, _ = tum.ate_rmse(tm.centers, _gt(sc), tm.cam_alive)
    assert float(rmse) < 0.1
    # the default draws (a generator seeded from ``seed``) verify the same graph
    tm2, tstats2 = tmerge.merge_scenes([to_port_session(s) for s in ref], seed=3)
    assert tstats2["tree"] == [(0, 1)] and tstats2["n_cameras"] == 14
    assert abs(tstats2["pair_inliers"][0] - tstats["pair_inliers"][0]) <= 3


def test_merge_keeps_three_sessions_connected(sessions):
    """A third session (the first again, shifted by a similarity) composes
    through the maximum-inlier spanning tree into session 0's frame."""
    sc, ref, _ = sessions
    s0 = to_port_session(ref[0])
    R = np.linalg.qr(np.random.default_rng(2).standard_normal((3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    cam_R, cam_t, X = tmerge.transform_scene_inplace(
        s0[0].cam_R.numpy(), s0[0].cam_t.numpy(), s0[0].X.numpy(), 0.5, R, np.ones(3))
    s3 = (dataclasses.replace(s0[0], cam_R=torch.from_numpy(cam_R.astype(np.float32)),
                              cam_t=torch.from_numpy(cam_t.astype(np.float32)),
                              X=torch.from_numpy(X.astype(np.float32))),) + s0[1:]
    merged, stats = tmerge.merge_scenes([s0, to_port_session(ref[1]), s3],
                                        noise=_edge_draws(0, 3))
    assert stats["n_cameras"] == 21 and len(stats["tree"]) == 2
    gt = torch.cat([_gt(sc), torch.from_numpy(sc.centers[0:7].astype(np.float32))])
    rmse, _ = tum.ate_rmse(merged.centers, gt, merged.cam_alive)
    assert float(rmse) < 0.1
