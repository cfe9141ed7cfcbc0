"""Self-calibration on the CPU: ``sfmx_torch.solvers.intrinsics``, the joint
pose, point and intrinsics LM (``lm.ba_solve_intrinsics`` on
``schur``'s planes pipeline) and ``reconstruct(refine_intrinsics=...)``
against ``sfmx`` on the same numpy inputs.

Tolerances, and why:
- ``_jacobians_k``: automatic differentiation of the same f32 formulas
  (reverse mode in the port, the reference's ``jax.jacfwd``): each block
  within 1e-5 of the largest entry of the reference's;
- the assembly and the K system (``assemble_with_intrinsics`` on the
  planes layout against the reference's blocks,
  ``reduce_system_k``, ``schur_matvec_k``, ``solve_points_k``): 1e-5 of the
  largest entry; b-vectors, near-cancelling sums taken in another order,
  1e-3; ``pcg_k``'s 20 steps amplify the matvecs' rounding: 1e-3;
- ``ba_solve_intrinsics``: every cost of the trace within 1e-4 relative of
  the reference's, plus 1e-4 of the final cost absolute (the problem starts
  10 % off in focal and falls 1,500x in one step to the noise floor, where
  the two solvers' steps differ by their PCGs' rounding and that moves a
  trial cost by up to 1.3e-4 of the floor); the refined focal within 1e-3
  relative and poses within 1e-3;
- ``refine_intrinsics_gn``: the refined table within 1e-3 relative;
- ``reconstruct``: the two draw different RANSAC samples, so the builds are
  compared by the reference test's gates on both sides (focal within 3 %,
  ATE < 0.1) and their focals within 1 % of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching as jmatching
from sfmx.recon import incremental as jinc
from sfmx.recon import tracks as jtracks
from sfmx.solvers import intrinsics as jintr
from sfmx.solvers import lm as jlm
from sfmx.solvers import schur as jschur
from sfmx_torch.recon import incremental as tinc
from sfmx_torch.recon.tracks import TrackTable
from sfmx_torch.solvers import intrinsics as tintr
from sfmx_torch.solvers import lm as tlm
from sfmx_torch.solvers import schur as tschur
from sfmx_torch.solvers import umeyama as tum
from tests.synthetic import make_scene
from tests.test_ba import build_obs_table
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-20))


def _joint_case(scale=1.10, k1=0.0, perturb=0.0):
    sc = make_scene(n_cams=8, n_points=150, noise_px=0.2, k1=k1)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    guess = sc.intrinsics.copy()
    guess[0] *= scale
    guess[1] *= scale
    rng = np.random.default_rng(0)
    X = sc.points + perturb * rng.standard_normal(sc.points.shape)
    fixed = np.zeros(8, bool)
    fixed[0] = True
    args = (guess[None].astype(np.float32), np.zeros(8, np.int32), sc.Rs.astype(np.float32),
            sc.ts.astype(np.float32), X.astype(np.float32), cam_id, pt_id, uv, w, fixed)
    return sc, args


def test_param_spec_and_delta_match_reference():
    assert tintr.PARAM_SPEC == jintr.PARAM_SPEC
    k = np.array([500.0, 510.0, 320.0, 240.0, -0.1, 0.02, 0.0], np.float32)
    params = ("f", "cx", "cy", "k1", "k2")
    d = np.array([3.0, -1.0, 2.0, 0.01, -0.002], np.float32)
    np.testing.assert_array_equal(tintr._delta_to_intr(T(k), T(d), params).numpy(),
                                  np.asarray(jintr._delta_to_intr(jnp.asarray(k), d, params)))
    # leading dimensions broadcast: (I,7) with (I,n_p) and with (n_p,)
    K = np.stack([k, k * 1.01])
    D = np.stack([d, 2 * d])
    got = tintr._delta_to_intr(T(K), T(D), params).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], tintr._delta_to_intr(T(K[i]), T(D[i]), params))
    assert tintr._delta_to_intr(T(K), T(d), params).shape == (2, 7)


@pytest.mark.parametrize("params", [("f",), ("f", "k1"), ("f", "cx", "cy", "k1", "k2")])
def test_jacobians_k_match_jacfwd(params):
    sc, args = _joint_case(k1=-0.05, perturb=0.02)
    intr, k_idx, R, t, X, cam_id, pt_id, uv = args[:8]
    f_ref = float(np.mean(0.5 * (intr[:, 0] + intr[:, 1])))
    ref = jlm._jacobians_k(*map(jnp.asarray, (intr, k_idx, R, t, X, cam_id, pt_id, uv)),
                           params, f_ref)
    got = tlm._jacobians_k(*map(T, (intr, k_idx, R, t, X, cam_id, pt_id, uv)), params, f_ref)
    assert got[3].shape == (len(cam_id), 2, len(params))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel(g.numpy(), r) < 1e-5


def _k_systems(params=("f", "k1"), lam=1e-3):
    sc, args = _joint_case(k1=-0.05, perturb=0.02)
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed = args
    order = np.argsort(pt_id, kind="stable")
    cam_id, pt_id, uv, w = cam_id[order], pt_id[order], uv[order], w[order]
    C, P = R.shape[0], X.shape[0]
    f_ref = float(intr[0, 0])
    r, Jc, Jp, Jk = jlm._jacobians_k(*map(jnp.asarray, (intr, k_idx, R, t, X, cam_id, pt_id,
                                                          uv)), params, f_ref)
    wj = jnp.asarray(w) * jlm.huber_weight(jnp.sum(r * r, -1), 4.0 / f_ref)
    group = k_idx[cam_id]
    jn = jschur.assemble_with_intrinsics(Jc, Jp, Jk, r, wj, cam_id, pt_id, group, k_idx, C, P, 1,
                                         pt_sorted=True)
    tn = tschur.assemble_with_intrinsics(*map(T, (Jc, Jp, Jk, r, wj, cam_id, pt_id, group,
                                                  k_idx)), C, P, 1)
    return jn, tn, jschur.reduce_system_k(jn, lam), tschur.reduce_system_k(tn, lam), fixed


def test_block_assembly_and_reduction_match_reference():
    jn, tn, js, ts, _ = _k_systems()
    # the port's pose/point part is the planes layout: V and W row-major
    O, P = len(tn.base.cam_id), tn.base.V9.shape[0]
    for got, ref in ((tn.base.U, jn.base.U), (tn.base.V9, np.asarray(jn.base.V).reshape(P, 9)),
                     (tn.base.W18, np.asarray(jn.base.Wc).reshape(O, 18))):
        assert rel(got.numpy(), ref) < 1e-5
    for name in ("Ukk", "Uck", "Wk"):
        assert rel(getattr(tn, name).numpy(), getattr(jn, name)) < 1e-5, name
    for a, b in ((tn.base.b_c, jn.base.b_c), (tn.base.b_p, jn.base.b_p), (tn.b_k, jn.b_k)):
        assert rel(a.numpy(), b) < 1e-3
    # the pose/point part alone: the planes reduction against the block one
    sys_j, sys_t = jschur.reduce_system(jn.base, 1e-3), tschur.reduce_system_planes(tn.base, 1e-3)
    assert rel(sys_t.Vinv9.numpy(), np.asarray(sys_j.Vinv).reshape(P, 9)) < 1e-4
    assert rel(sys_t.Ud.numpy(), sys_j.Ud) < 1e-5
    assert rel(sys_t.b_red.numpy(), sys_j.b_red) < 1e-3
    assert rel(ts.Ukk_d.numpy(), js.Ukk_d) < 1e-5 and rel(ts.b_red_k.numpy(), js.b_red_k) < 1e-3


def test_schur_k_ops_and_pcg_k_match_reference():
    jn, tn, js, ts, fixed = _k_systems()
    rng = np.random.default_rng(3)
    xc = rng.standard_normal((8, 6)).astype(np.float32)
    xk = rng.standard_normal((1, 2)).astype(np.float32)
    yc, yk = jschur.schur_matvec_k(js, jnp.asarray(xc), jnp.asarray(xk), pt_sorted=True)
    tyc, tyk = tschur.schur_matvec_k(ts, T(xc), T(xk))
    assert rel(tyc.numpy(), yc) < 1e-4 and rel(tyk.numpy(), yk) < 1e-4
    dp = jschur.solve_points_k(js, jnp.asarray(xc), jnp.asarray(xk), pt_sorted=True)
    assert rel(tschur.solve_points_k(ts, T(xc), T(xk)).numpy(), dp) < 1e-4
    dc, dk = jschur.pcg_k(js, iters=20, fixed_cam_mask=jnp.asarray(fixed), pt_sorted=True)
    tdc, tdk = tschur.pcg_k(ts, iters=20, fixed_cam_mask=T(fixed))
    assert rel(tdc.numpy(), dc) < 1e-3 and rel(tdk.numpy(), dk) < 1e-3
    assert np.all(tdc.numpy()[0] == 0.0)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_inv_spd_other_sizes(k):
    rng = np.random.default_rng(k)
    A = rng.standard_normal((4, k, k))
    M = (A @ A.transpose(0, 2, 1) + k * np.eye(k)).astype(np.float32)
    got = tschur._inv_spd(T(M)).numpy()
    assert rel(got, np.asarray(jschur._inv_spd(jnp.asarray(M)))) < 1e-5


def test_joint_ba_with_intrinsics():
    """Wrong focal: the joint pose+point+intrinsics LM recovers it (the
    reference test's gates), and its cost trace is the reference's."""
    sc, args = _joint_case()
    kw = dict(params=("f",), iters=25, cg_iters=40)
    R, t, X, intr, costs = tlm.ba_solve_intrinsics(*map(T, args), **kw)
    rmse = tlm.reprojection_rmse(intr, T(args[1]), R, t, X, *map(T, args[5:9]))
    focal_err = abs(float(intr[0, 0]) - sc.intrinsics[0]) / sc.intrinsics[0]
    assert float(rmse) < 0.3, float(rmse)
    assert focal_err < 0.02, focal_err
    Rr, tr, Xr, intr_r, costs_r = jlm.ba_solve_intrinsics(*map(jnp.asarray, args), **kw)
    costs_r = np.asarray(costs_r)
    np.testing.assert_allclose(costs.numpy(), costs_r, rtol=1e-4, atol=1e-4 * costs_r[-1])
    assert costs_r[-1] < 1e-3 * costs_r[0]
    assert abs(float(intr[0, 0]) / float(intr_r[0, 0]) - 1.0) < 1e-3
    assert np.abs(R.numpy() - np.asarray(Rr)).max() < 1e-3
    assert np.abs(t.numpy() - np.asarray(tr)).max() < 1e-3
    np.testing.assert_array_equal(R.numpy()[0], args[2][0])      # the fixed camera


def test_refine_recovers_focal_and_k1():
    sc = make_scene(n_cams=8, n_points=150, noise_px=0.2, k1=-0.15)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    guess = sc.intrinsics.copy()
    guess[0] *= 1.15
    guess[1] *= 1.15
    guess[4] = 0.0
    args = (guess[None].astype(np.float32), np.zeros(8, np.int32), sc.Rs.astype(np.float32),
            sc.ts.astype(np.float32), sc.points.astype(np.float32), cam_id, pt_id, uv, w)
    out = tintr.refine_intrinsics_gn(*map(T, args), params=("f", "k1"), iters=8).numpy()[0]
    assert abs(out[0] - sc.intrinsics[0]) / sc.intrinsics[0] < 0.01, out[0]
    assert abs(out[4] - (-0.15)) < 0.02, out[4]
    ref = np.asarray(jintr.refine_intrinsics_gn(*map(jnp.asarray, args), params=("f", "k1"),
                                                iters=8))[0]
    assert abs(out[0] / ref[0] - 1.0) < 1e-3 and abs(out[4] - ref[4]) < 1e-3 * abs(ref[4])
    np.testing.assert_array_equal(out[[2, 3, 5, 6]], ref[[2, 3, 5, 6]])


def test_reconstruct_with_intrinsics_refinement():
    """End to end: a map built with a 10 %-wrong focal guess self-calibrates
    in both packages."""
    rng = np.random.default_rng(3)
    sc = make_scene(n_cams=10, n_points=250, noise_px=0.3, seed=11)
    uv, desc, mask, _ = scene_features(sc, rng, noise=0.05)
    C = uv.shape[0]
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = jmatching.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    jtt = jtracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), C, uv.shape[1])
    tt = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    guess = sc.intrinsics.copy()
    guess[0] *= 1.10
    guess[1] *= 1.10
    intr = guess[None].astype(np.float32)
    scene, stats = tinc.reconstruct(uv, mask, tt, intr, np.zeros(C, np.int32),
                                    tinc.ReconConfig(refine_intrinsics=("f",)), device="cpu")
    f_est = float(scene.intr[0, 0])
    assert abs(f_est - sc.intrinsics[0]) / sc.intrinsics[0] < 0.03, f_est
    rmse, _ = tum.ate_rmse(scene.centers, T(sc.centers.astype(np.float32)), scene.cam_alive)
    assert float(rmse) < 0.1
    np.testing.assert_allclose(np.asarray(stats["refined_intrinsics"]), scene.intr.numpy())
    jscene, jstats = jinc.reconstruct(uv, mask, jtt, intr, np.zeros(C, np.int32),
                                      jinc.ReconConfig(refine_intrinsics=("f",)))
    f_ref = float(np.asarray(jscene.intr)[0, 0])
    assert abs(f_ref - sc.intrinsics[0]) / sc.intrinsics[0] < 0.03
    assert abs(f_est / f_ref - 1.0) < 0.01
    assert jstats["n_registered"] == stats["n_registered"] == C


def test_reconstruct_reports_the_joint_lm_final_cost(monkeypatch):
    """stats["intrinsics_ba_costs"] is (the joint LM's first cost, the cost
    of the state it returns): a last trial that came out non-finite, and so
    was not taken, does not make the second NaN (seen on the card)."""
    from sfmx_torch.solvers import lm as tlm

    rng = np.random.default_rng(3)
    sc = make_scene(n_cams=8, n_points=200, noise_px=0.3, seed=11)
    uv, desc, mask, _ = scene_features(sc, rng, noise=0.05)
    C = uv.shape[0]
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = jmatching.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    jtt = jtracks.build_tracks(pairs, np.asarray(res.idx), np.asarray(res.valid), C, uv.shape[1])
    tt = TrackTable(jtt.obs_cam, jtt.obs_feat, jtt.obs_track, jtt.n_tracks)
    guess = sc.intrinsics.copy()
    guess[:2] *= 1.05
    traces = []
    real = tlm.ba_solve_intrinsics

    def with_nan_trial(*a, **kw):
        R, t, X, intr, costs = real(*a, **kw)
        traces.append(costs)
        return R, t, X, intr, torch.cat([costs, costs.new_tensor([float("nan")])])

    monkeypatch.setattr(tlm, "ba_solve_intrinsics", with_nan_trial)
    _scene, stats = tinc.reconstruct(uv, mask, tt, guess[None].astype(np.float32),
                                     np.zeros(C, np.int32),
                                     tinc.ReconConfig(refine_intrinsics=("f",)), device="cpu")
    assert len(traces) == 1
    c0, c1 = stats["intrinsics_ba_costs"]
    assert c0 == float(traces[0][0]) and c1 == float(traces[0].min())
    assert np.isfinite(c1) and c1 <= c0
