"""Incremental reconstruction on the CPU: the port's device steps with the
reference's Gumbel draws injected, and ``reconstruct`` on a small synthetic
track table, against ``sfmx.recon.incremental``.

Tolerances, and why:
- device steps with the same minimal samples (the draws the reference makes
  from its key): the two sides' SVDs, Cholesky solves and Gauss-Newton round
  differently, so the winning model is the same hypothesis or one that ties
  it; inlier counts within 2, R and t within 2e-3 (init pair; t has unit
  norm) and 1e-3 (resection, after the GN refine), the parallax median
  within 0.05 degrees, inlier masks equal but for at most 2 matches;
- ``_triangulate_all``: X within 2e-3 where both accept (inverse iteration
  against ``eigh``), the accept masks differ in at most 1 % of the tracks (a
  gate value within rounding of its threshold);
- ``_reproj_err2_norm``: the same formula, rtol 1e-4;
- ``reconstruct``: the two draw different RANSAC samples (``jax.random``
  against a ``torch.Generator``), so the scenes are compared after a
  similarity alignment and not slot by slot: every camera registered on
  both, ATE < 0.1 and median structure error < 0.05 (the gates of
  tests/test_recon_e2e.py), camera centers of the two scenes within 0.05
  after alignment (both sit at the same noise floor of a scene ~12 units
  across), median reprojection within 0.1 px of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.core import cameras as jcam
from sfmx.kernels import matching as jmatching
from sfmx.recon import incremental as jinc
from sfmx.recon import tracks as jtracks
from sfmx_torch.recon import incremental as tinc
from sfmx_torch.recon.tracks import TrackTable
from sfmx_torch.solvers import umeyama as tum
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)
H = 64                        # RANSAC hypotheses in the step tests


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    sc = make_scene(n_cams=8, n_points=250, noise_px=0.3, seed=3)
    uv, desc, mask, feat_pt = scene_features(sc, rng, noise=0.05)
    C = uv.shape[0]
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = jmatching.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    jtt = jtracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), C, uv.shape[1])
    tt = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    intr = sc.intrinsics[None].astype(np.float32)
    xn = np.asarray(jax.vmap(lambda u: jcam.pixel_to_normalized(jnp.asarray(intr[0]), u))(
        jnp.asarray(uv)))
    return sc, uv, mask, feat_pt, jtt, tt, intr, xn


def _shared(case, a, b):
    """Normalized coords of the landmarks cameras a and b share, padded to K."""
    sc, uv, mask, feat_pt, _, _, _, xn = case
    K = uv.shape[1]
    ids, ia, ib = np.intersect1d(feat_pt[a][mask[a]], feat_pt[b][mask[b]], return_indices=True)
    xa, xb = np.zeros((K, 2), np.float32), np.zeros((K, 2), np.float32)
    valid = np.zeros(K, bool)
    xa[:len(ids)], xb[:len(ids)] = xn[a][mask[a]][ia], xn[b][mask[b]][ib]
    valid[:len(ids)] = True
    # a few wrong correspondences for RANSAC to reject
    xb[:6] = xb[:6][::-1] + 0.05
    return xa, xb, valid, ids


def test_init_pair_step_matches_reference(case):
    xa, xb, valid, _ = _shared(case, 2, 5)
    thresh = (4.0 / 520.0) ** 2
    key = jax.random.PRNGKey(3)
    Rr, tr, inr, cr, pr = jinc._init_pair_step(key, jnp.asarray(xa), jnp.asarray(xb),
                                               jnp.asarray(valid), thresh, H)
    g = T(jax.random.gumbel(key, (H, len(valid))))
    R, t, inl, cnt, par = tinc._init_pair_step(g, T(xa), T(xb), T(valid), thresh)
    assert abs(int(cnt) - int(cr)) <= 2 and int(cnt) >= valid.sum() - 8
    assert int((inl.numpy() != np.asarray(inr)).sum()) <= 2
    assert np.abs(R.numpy() - np.asarray(Rr)).max() < 2e-3
    assert np.abs(t.numpy() - np.asarray(tr)).max() < 2e-3
    assert abs(float(par) - float(pr)) < 0.05
    # the batched form gives each pair the result of its own step
    xa2, xb2, valid2, _ = _shared(case, 0, 3)
    g2 = T(jax.random.gumbel(jax.random.PRNGKey(4), (H, len(valid))))
    Rb, tb, inb, cb, pb = tinc._init_pair_batch(
        torch.stack([g, g2]), T(np.stack([xa, xa2])), T(np.stack([xb, xb2])),
        T(np.stack([valid, valid2])), thresh)
    assert torch.equal(inb[0], inl) and int(cb[0]) == int(cnt)
    np.testing.assert_allclose(Rb[0].numpy(), R.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(pb[0]), float(par), atol=1e-3)
    assert int(cb[1]) >= valid2.sum() - 8


@pytest.mark.parametrize("solver", ["dlt6", "p3p"])
def test_resect_step_matches_reference(case, solver):
    sc, uv, mask, feat_pt, _, _, _, xn = case
    c = 4
    K = uv.shape[1]
    X = np.zeros((K, 3), np.float32)
    X[mask[c]] = sc.points[feat_pt[c][mask[c]]]
    valid = mask[c].copy()
    X[:5] += 0.5                                   # wrong 2D-3D pairs
    thresh = (4.0 / 520.0) ** 2
    key = jax.random.PRNGKey(5)
    Rr, tr, inr, cr = jinc._resect_step(key, jnp.asarray(xn[c]), jnp.asarray(X),
                                        jnp.asarray(valid), thresh, H, solver)
    g = T(jax.random.gumbel(key, (H, K)))
    R, t, inl, cnt = tinc._resect_step_impl(g, T(xn[c]), T(X), T(valid), thresh, solver)
    assert abs(int(cnt) - int(cr)) <= 2 and int(cnt) >= valid.sum() - 7
    assert int((inl.numpy() != np.asarray(inr)).sum()) <= 2
    assert np.abs(R.numpy() - np.asarray(Rr)).max() < 1e-3
    assert np.abs(t.numpy() - np.asarray(tr)).max() < 1e-3
    assert np.abs(R.numpy() - sc.Rs[c]).max() < 5e-3 and np.abs(t.numpy() - sc.ts[c]).max() < 3e-2


def test_triangulate_all_and_reproj_match_reference(case):
    sc, uv, mask, feat_pt, jtt, tt, intr, xn = case
    C, K = mask.shape
    Tn, V = tt.n_tracks, 8
    starts, ends = tt.track_slices()
    cam = np.zeros((Tn, V), np.int32)
    feat = np.zeros((Tn, V), np.int32)
    m = np.zeros((Tn, V), bool)
    for i, (s, e) in enumerate(zip(starts, ends)):
        n = min(e - s, V)
        cam[i, :n], feat[i, :n], m[i, :n] = tt.obs_cam[s:s + n], tt.obs_feat[s:s + n], True
    registered = np.ones(C, bool)
    registered[[1, 6]] = False
    R, t = sc.Rs.astype(np.float32), sc.ts.astype(np.float32)
    thresh = (4.0 / 520.0) ** 2
    Xr, okr = jinc._triangulate_all(*map(jnp.asarray, (R, t, registered, xn, cam, feat, m)),
                                    thresh, 1.5)
    X, ok = tinc._triangulate_all(*map(T, (R, t, registered, xn, cam, feat, m)), thresh, 1.5)
    okr = np.asarray(okr)
    assert (ok.numpy() != okr).mean() <= 0.01 and okr.sum() > 0.8 * Tn
    both = ok.numpy() & okr
    assert np.abs(X.numpy()[both] - np.asarray(Xr)[both]).max() < 2e-3
    xn_obs = xn[tt.obs_cam, tt.obs_feat]
    er = jinc._reproj_err2_norm(*map(jnp.asarray, (R, t, np.asarray(Xr), tt.obs_cam,
                                                   tt.obs_track, xn_obs)))
    e = tinc._reproj_err2_norm(*map(T, (R, t, np.asarray(Xr), tt.obs_cam, tt.obs_track, xn_obs)))
    np.testing.assert_allclose(e.numpy(), np.asarray(er), rtol=1e-4, atol=1e-9)


def _recon(case, **kw):
    sc, uv, mask, _, _, tt, intr, _ = case
    cfg = tinc.ReconConfig(ba_every=3, ransac_hypotheses=128, **kw)
    return tinc.reconstruct(uv, mask, tt, intr, np.zeros(len(uv), np.int32), cfg, device="cpu")


@pytest.fixture(scope="module")
def port_result(case):
    return _recon(case)


def _gates(case, scene, stats):
    sc, uv, mask, feat_pt, _, tt, _, _ = case
    assert stats["n_registered"] == len(uv) and stats["n_points"] > 150
    ref = T(sc.centers.astype(np.float32))
    rmse, (s, R, t) = tum.ate_rmse(scene.centers, ref, scene.cam_alive)
    assert float(rmse) < 0.1
    starts, _ = tt.track_slices()
    gt = np.array([feat_pt[tt.obs_cam[s0], tt.obs_feat[s0]] for s0 in starts])
    alive = scene.X_alive.numpy()
    Xw = tum.apply_sim3(s, R, t, scene.X).numpy()
    assert np.median(np.linalg.norm(Xw[alive] - sc.points[gt[alive]], axis=1)) < 0.05
    return float(rmse)


def test_reconstruct_registers_all_and_matches_reference(case, port_result):
    sc, uv, mask, _, jtt, tt, intr, _ = case
    scene, stats = port_result
    _gates(case, scene, stats)
    jscene, jstats = jinc.reconstruct(uv, mask, jtt, intr, np.zeros(len(uv), np.int32),
                                      jinc.ReconConfig(ba_every=3, ransac_hypotheses=128))
    assert jstats["n_registered"] == stats["n_registered"] == len(uv)
    assert abs(jstats["n_points"] - stats["n_points"]) <= 0.05 * jstats["n_points"]
    assert abs(jstats["final_med_px"] - stats["final_med_px"]) < 0.1
    rmse, _ = tum.ate_rmse(scene.centers, T(jscene.centers), scene.cam_alive)
    assert float(rmse) < 0.05
    assert stats["ba_path"] == {"mode": "planes", "why": "cpu-or-small"}
    assert stats["ba_calls"]["planes"] == len(stats["ba_costs"]) and stats["ba_calls"]["dense"] == 0
    assert set(stats["phase_s"]) == set(jstats["phase_s"])
    for key in ("ba_call_s", "ba_iters_per_s", "init_pair", "init_med_px", "n_rounds"):
        assert key in stats and key in jstats
    assert scene.capacities == (len(uv), tt.n_tracks, len(tt.obs_cam))
    assert scene.counts()[0] == len(uv) and scene.obs_alive.dtype == torch.bool


def test_reconstruct_dense_ba_on_matches_off(case, port_result):
    """``dense_ba="on"`` (the plain K6-K8 on the CPU) against the planes
    path: the same cameras, the same trajectory to 0.02 after alignment."""
    scene, stats = port_result
    scene2, stats2 = _recon(case, dense_ba="on", dense_ba_min_obs=1)
    assert stats2["ba_path"]["mode"] == "dense" and stats2["ba_calls"]["planes"] == 0
    assert stats2["ba_path"]["tp"] == 8 and stats2["ba_path"]["ov_cap"] == 0
    _gates(case, scene2, stats2)
    rmse, _ = tum.ate_rmse(scene2.centers, scene.centers, scene.cam_alive)
    assert float(rmse) < 0.02
    _, stats3 = _recon(case, dense_ba="off")
    assert stats3["ba_path"] == {"mode": "planes", "why": "disabled"}


def test_reconstruct_sequential_and_callbacks(case):
    seen = []
    sc, uv, mask, _, _, tt, intr, _ = case
    cfg = tinc.ReconConfig(ba_every=2, ransac_hypotheses=128, batch_resection=False)
    scene, stats = tinc.reconstruct(uv, mask, tt, intr, np.zeros(len(uv), np.int32), cfg,
                                    callbacks=lambda reg, alive: seen.append(int(reg.sum())),
                                    device="cpu")
    _gates(case, scene, stats)
    assert seen == sorted(seen) and seen[-1] == len(uv) and len(seen) >= 6


def test_reconstruct_errors(case, tmp_path):
    """What used to raise now runs as the reference does: no tracks is a
    ReconError; ``final_ba_ckpt`` checkpoints the final BA; ``refine_intrinsics``
    refines the focal; two groups of 8 cameras with no pair across them
    record a failed secondary component and keep the 8 primary cameras, in
    both packages."""
    sc, uv, mask, _, _, tt, intr, _ = case
    cam_k = np.zeros(len(uv), np.int32)
    empty = TrackTable(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32), 0)
    with pytest.raises(tinc.ReconError, match="no tracks"):
        tinc.reconstruct(uv, mask, empty, intr, cam_k, device="cpu")
    ckpt = tmp_path / "final_ba.npz"
    cfg = tinc.ReconConfig(ba_every=3, ransac_hypotheses=128, final_ba_ckpt=str(ckpt),
                           refine_intrinsics=("f",))
    scene, stats = tinc.reconstruct(uv, mask, tt, intr, cam_k, cfg, device="cpu")
    _gates(case, scene, stats)
    with np.load(ckpt) as z:
        assert int(z["it"]) == cfg.final_ba_iters and int(z["version"]) == 1
    f_est = float(scene.intr[0, 0])
    assert abs(f_est / sc.intrinsics[0] - 1.0) < 0.03 and stats["refined_intrinsics"][0][0] == f_est
    # two groups of 8 cameras with no pair across them: the primary component
    # strands 8 >= max(4, 30 // 4) cameras under coverage_target, the
    # secondary seeds among them but shares no track or camera with the
    # primary, so its fusion fails verification (twice: once more with a
    # doubled bridge) and the map keeps the primary
    big = make_scene(n_cams=16, n_points=250, noise_px=0.3, seed=3)
    rng = np.random.default_rng(7)
    uv2, desc2, mask2, _ = scene_features(big, rng, noise=0.05)
    pairs = np.array([(a, b) for a in range(8) for b in range(a + 1, 8)]
                     + [(a, b) for a in range(8, 16) for b in range(a + 1, 16)], np.int32)
    res = jmatching.match_pairs_float(jnp.asarray(desc2), jnp.asarray(mask2), jnp.asarray(pairs))
    jtt = jtracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), 16, uv2.shape[1])
    tt2 = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    cam_k2 = np.zeros(16, np.int32)
    scene, stats = tinc.reconstruct(uv2, mask2, tt2, intr, cam_k2,
                                    tinc.ReconConfig(ransac_hypotheses=128), device="cpu")
    jscene, jstats = jinc.reconstruct(uv2, mask2, jtt, intr, cam_k2,
                                      jinc.ReconConfig(ransac_hypotheses=128))
    assert stats["n_registered"] == jstats["n_registered"] == 8
    assert [c["component"] for c in stats["components"]] == \
        [c["component"] for c in jstats["components"]] == [0, 1, 1]
    for got, ref in zip(stats["components"][1:], jstats["components"][1:]):
        assert got["new_cams"] == ref["new_cams"] == 8
        assert got["fail"].startswith("sim3 verification: point-correspondence registration "
                                      "failed verification")
        assert ref["fail"].startswith("sim3 verification: point-correspondence registration "
                                      "failed verification")
    assert np.array_equal(scene.cam_alive.numpy(), np.asarray(jscene.cam_alive))
    assert stats["component_loop_s"]["wall"] > 0
    scene1, stats1 = tinc.reconstruct(uv2, mask2, tt2, intr, cam_k2,
                                      tinc.ReconConfig(ransac_hypotheses=128, max_components=1),
                                      device="cpu")
    assert stats1["n_registered"] == 8 and stats1["components"] == [
        {"component": 0, "registered": 8}]
    # the failed components left no trace: every piece of state they touched
    # came back from the snapshot, so the final BA saw the same input
    for f in ("cam_R", "cam_t", "cam_alive", "X", "X_alive", "obs_alive"):
        assert torch.equal(getattr(scene, f), getattr(scene1, f)), f


def test_recon_config_equals_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jinc.ReconConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tinc.ReconConfig)}
    assert got == ref
