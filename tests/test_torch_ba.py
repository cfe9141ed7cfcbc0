"""Bundle adjustment on the CPU: the port's Schur pipelines and ``ba_solve``
against ``sfmx.solvers`` on the same numpy inputs.

Tolerances, and why:
- ``_jacobians_planes``, ``assemble_planes``, ``_inv_spd``: the same f32
  formulas on both sides; within 1e-5 relative to the largest entry (b_c and
  b_p, near-cancelling sums taken in another order: 1e-3);
- ``pcg_planes`` / ``pcg_dense``: 25 CG steps amplify the summation-order
  differences of every matvec; solutions within 1e-3 of the largest entry
  (the reference's own tolerance between its two PCGs);
- ``ba_solve``: LM is a chaotic map of its rounding (one accept/reject flip
  changes the trace), so the traces are compared where LM is stable: the
  first cost to 1e-4, every later cost within 2 % of the reference's while
  the cost is still above twice its final value, the final cost within 2 %
  (the reference's tolerance between its own two paths), poses and points
  within 1e-3 (scene units; the scene spans ~10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.solvers import lm as jlm
from sfmx.solvers import schur as jschur
from sfmx_torch.kernels import segsum as tseg
from sfmx_torch.solvers import lm as tlm
from sfmx_torch.solvers import schur as tschur
from tests.synthetic import make_scene
from tests.test_ba import build_obs_table
from tests.test_segsum import _planes_system, _raw_local_scene

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-20))


def test_jacobians_and_assembly_match_reference():
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, _ = _raw_local_scene()
    C, P = R.shape[0], X.shape[0]
    r, Jc, Jp = jlm._jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv)
    tr, tJc, tJp = tlm._jacobians_planes(T(intr), T(k_idx), T(R), T(t), T(X), T(cam_id),
                                         T(pt_id), T(uv))
    assert rel(tr.numpy(), r) < 1e-5 and rel(tJc.numpy(), Jc) < 1e-5 and rel(tJp.numpy(), Jp) < 1e-5
    delta = 1.0 / 500.0
    wh = w * jlm.huber_weight(jnp.sum(r * r, -1), delta)
    twh = T(w) * tlm.huber_weight(torch.sum(tr * tr, -1), delta)
    assert rel(twh.numpy(), wh) < 1e-5
    nb = jschur.assemble_planes(Jc, Jp, r, wh, cam_id, pt_id, C, P, pt_sorted=True)
    tnb = tschur.assemble_planes(tJc, tJp, tr, twh, tschur.segment_plan(T(cam_id), C),
                                 tschur.segment_plan(T(pt_id), P))
    assert rel(tnb.U.numpy(), nb.U) < 1e-5 and rel(tnb.V9.numpy(), nb.V9) < 1e-5
    assert rel(tnb.W18.numpy(), nb.W18) < 1e-5
    assert rel(tnb.b_c.numpy(), nb.b_c) < 1e-3 and rel(tnb.b_p.numpy(), nb.b_p) < 1e-3
    np.testing.assert_allclose(
        float(tlm.robust_cost(torch.sum(tr * tr, -1), T(w), delta)),
        float(jlm.robust_cost(jnp.sum(r * r, -1), w, delta)), rtol=1e-5)
    lam = 1e-3
    sysp = jschur.reduce_system_planes(nb, lam, pt_sorted=True)
    tsys = tschur.reduce_system_planes(tnb, lam)
    assert rel(tsys.Vinv9.numpy(), sysp.Vinv9) < 1e-4
    assert rel(tsys.Ud.numpy(), sysp.Ud) < 1e-5
    assert rel(tsys.b_red.numpy(), sysp.b_red) < 1e-3


@pytest.mark.parametrize("k", [3, 6])
def test_inv_spd_matches_reference(k):
    rng = np.random.default_rng(k)
    A = rng.standard_normal((50, k, k + 4)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(k, dtype=np.float32)
    ref = np.asarray(jschur._inv_spd(jnp.asarray(M)))
    got = tschur._inv_spd(T(M)).numpy()
    assert rel(got, ref) < 1e-5
    assert np.abs(got @ M - np.eye(k)).max() < 1e-3
    np.testing.assert_allclose(tschur._damp(T(M), 0.5).numpy(),
                               np.asarray(jschur._damp(jnp.asarray(M), 0.5)), rtol=1e-6)


def _torch_planes(sysp):
    nb = sysp.blocks
    tnb = tschur.NormalBlocksP(T(nb.U), T(nb.V9), T(nb.W18), T(nb.b_c), T(nb.b_p),
                               tschur.segment_plan(T(nb.cam_id), nb.U.shape[0]),
                               tschur.segment_plan(T(nb.pt_id), nb.V9.shape[0]))
    return tschur.SchurSystemP(tnb, T(sysp.Vinv9), T(sysp.Ud), T(sysp.b_red))


def test_pcg_planes_matches_reference():
    sysp, _, _, _ = _planes_system()
    C = 24
    fixed = np.zeros(C, bool)
    fixed[0] = True
    tsys = _torch_planes(sysp)
    x = np.random.default_rng(5).standard_normal((C, 6)).astype(np.float32)
    assert rel(tschur.schur_matvec_planes(tsys, T(x)).numpy(),
               jschur.schur_matvec_planes(sysp, jnp.asarray(x), pt_sorted=True)) < 1e-4
    assert rel(tschur.solve_points_planes(tsys, T(x)).numpy(),
               jschur.solve_points_planes(sysp, jnp.asarray(x), pt_sorted=True)) < 1e-4
    dx_ref, rn_ref = jschur.pcg_planes(sysp, iters=25, fixed_cam_mask=jnp.asarray(fixed),
                                       pt_sorted=True)
    dx, rn = tschur.pcg_planes(tsys, iters=25, fixed_cam_mask=T(fixed))
    assert rel(dx.numpy(), dx_ref) < 1e-3
    assert np.all(dx.numpy()[0] == 0.0)


@pytest.mark.parametrize("tp_cap", [32, 4], ids=["fits", "overflow"])
def test_reduce_and_pcg_dense_match_planes(tp_cap):
    """The dense pipeline (K7 -> K6, plain on the CPU) on the raw local
    scene, with the overflow observations of a deliberately small tp_cap
    chained in, against the reference's planes pipeline over the full table:
    the reduced system, the PCG solution and the back-substitution."""
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, _ = _raw_local_scene(C=40, P=300, O=3000)
    C, P = R.shape[0], X.shape[0]
    delta, lam = 1.0 / 500.0, 1e-3
    r, Jc, Jp = jlm._jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv)
    wh = w * jlm.huber_weight(jnp.sum(r * r, -1), delta)
    nb = jschur.assemble_planes(Jc, Jp, r, wh, cam_id, pt_id, C, P, pt_sorted=True)
    sysp = jschur.reduce_system_planes(nb, lam, pt_sorted=True)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    dx_ref, _ = jschur.pcg_planes(sysp, iters=25, fixed_cam_mask=jnp.asarray(fixed),
                                  pt_sorted=True)
    dxp_ref = jschur.solve_points_planes(sysp, dx_ref, pt_sorted=True)

    tc, tp_, tuv, tw = T(cam_id), T(pt_id), T(uv), T(w)
    d = tseg.build_dense_obs(tp_, tc, P, C, tp_cap)
    uvw = tseg.pack_rows(d, torch.cat([tuv, tw[:, None]], 1))
    lens = np.bincount(np.asarray(pt_id), minlength=P)
    ov_blocks = ov_cost = None
    if lens.max() > tp_cap:
        start = np.searchsorted(np.asarray(pt_id), np.arange(P))
        ovi = T(np.flatnonzero(np.arange(len(lens.repeat(lens))) - start[np.asarray(pt_id)]
                               >= tp_cap))
        r_o, Jc_o, Jp_o = tlm._jacobians_planes(T(intr), T(k_idx), T(R), T(t), T(X),
                                                tc[ovi], tp_[ovi], tuv[ovi])
        r2o = torch.sum(r_o * r_o, -1)
        ov_blocks = tschur.assemble_planes(Jc_o, Jp_o, r_o, tw[ovi] * tlm.huber_weight(r2o, delta),
                                           tschur.segment_plan(tc[ovi], C),
                                           tschur.segment_plan(tp_[ovi], P))
        ov_cost = tlm.robust_cost(r2o, tw[ovi], delta)
    else:
        assert tp_cap == 32
    sysd, cost = tschur.reduce_system_fused(T(intr), T(k_idx), T(R), T(t), T(X),
                                            tseg.AssembleFused(d, uvw), lam, delta,
                                            ov_blocks=ov_blocks, ov_cost=ov_cost)
    np.testing.assert_allclose(float(cost), float(jlm.robust_cost(jnp.sum(r * r, -1), w, delta)),
                               rtol=1e-4)
    assert rel(sysd.Ud.numpy(), sysp.Ud) < 1e-4
    assert rel(sysd.b_red.numpy(), sysp.b_red) < 2e-3
    dx, _ = tschur.pcg_dense(sysd, iters=25, fixed_cam_mask=T(fixed))
    assert rel(dx.numpy(), dx_ref) < 1e-3
    dxp = tschur.solve_points_dense(sysd, T(dx_ref))
    assert dxp.shape == (P, 3)
    assert rel(dxp.numpy(), dxp_ref) < 1e-3


def _perturbed(n_cams=8, n_points=120, noise_px=0.3, seed=2):
    sc = make_scene(n_cams=n_cams, n_points=n_points, noise_px=noise_px)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    rng = np.random.default_rng(seed)
    R0 = sc.Rs.astype(np.float32)
    t0 = (sc.ts + 0.03 * rng.standard_normal((n_cams, 3))).astype(np.float32)
    X0 = (sc.points + 0.03 * rng.standard_normal((n_points, 3))).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    args = (np.asarray(sc.intrinsics, np.float32)[None], np.zeros(n_cams, np.int32), R0, t0, X0,
            cam_id, pt_id, uv, w, fixed)
    return sc, args


def _check_trace(costs, ref):
    costs, ref = np.asarray(costs), np.asarray(ref)
    assert costs.shape == ref.shape
    np.testing.assert_allclose(costs[0], ref[0], rtol=1e-4)
    early = ref > 2.0 * ref[-1]
    np.testing.assert_allclose(costs[early], ref[early], rtol=0.02)
    np.testing.assert_allclose(costs[-1], ref[-1], rtol=0.02)
    assert (np.diff(costs) <= 0).all()          # a rejected step keeps the cost


@pytest.mark.parametrize("path", ["planes", "dense", "dense-overflow"])
def test_ba_solve_matches_reference(path):
    """``ba_solve`` against ``lm.ba_solve`` on the perturbed 8-camera orbit:
    the cost trace and the final R, t, X.  dense-overflow uses tp_cap=4 with
    the exact overflow count as ov_cap, as tests/test_segsum.py does."""
    sc, args = _perturbed()
    lens = np.bincount(args[6], minlength=120)
    kw = {"planes": dict(tp_cap=16), "dense": dict(tp_cap=16, dense_cg=True),
          "dense-overflow": dict(tp_cap=4, dense_cg=True,
                                 ov_cap=int(np.maximum(lens - 4, 0).sum()))}[path]
    jargs = tuple(jnp.asarray(a) for a in args)
    Rr, tr, Xr, cr = jlm.ba_solve(*jargs, iters=8, cg_iters=25, **kw)
    tkw = {k: v for k, v in kw.items() if path != "planes" or k != "tp_cap"}
    R, t, X, c, lam = tlm.ba_solve(*(T(a) for a in args), iters=8, cg_iters=25,
                                   return_lam=True, **tkw)
    _check_trace(c.numpy(), cr)
    assert float(c[-1]) < 0.1 * float(c[0])
    assert np.abs(R.numpy() - np.asarray(Rr)).max() < 1e-3
    assert np.abs(t.numpy() - np.asarray(tr)).max() < 1e-3
    assert np.abs(X.numpy() - np.asarray(Xr)).max() < 1e-3
    assert 1e-9 <= float(lam) <= 1e6
    np.testing.assert_array_equal(R.numpy()[0], args[2][0])      # the fixed camera


def test_ba_solve_overflow_needs_ov_cap():
    sc, args = _perturbed()
    with pytest.raises(ValueError, match="ov_cap"):
        tlm.ba_solve(*(T(a) for a in args), iters=1, tp_cap=4, dense_cg=True, ov_cap=3)
    with pytest.raises(ValueError, match="tp_cap"):
        tlm.ba_solve(*(T(a) for a in args), iters=1, dense_cg=True)


@pytest.mark.parametrize("dense", [False, True], ids=["planes", "dense"])
def test_ba_converges_from_perturbed_scene(dense):
    """As tests/test_ba.py: a noiseless 6-camera scene, perturbed, converges
    to a near-zero residual."""
    sc = make_scene(n_cams=6, n_points=80, noise_px=0.0)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    C, P = 6, 80
    g = torch.Generator().manual_seed(0)
    from sfmx_torch.core import se3
    R0 = se3.so3_exp_b(0.01 * torch.randn((C, 3), generator=g)) @ T(sc.Rs.astype(np.float32))
    t0 = T(sc.ts.astype(np.float32)) + 0.02 * torch.randn((C, 3), generator=g)
    X0 = T(sc.points.astype(np.float32)) + 0.03 * torch.randn((P, 3), generator=g)
    intr = T(np.asarray(sc.intrinsics, np.float32)[None])
    k_idx = torch.zeros(C, dtype=torch.int32)
    fixed = torch.zeros(C, dtype=torch.bool)
    fixed[0] = True
    obs = (T(cam_id), T(pt_id), T(uv), T(w))
    rmse0 = tlm.reprojection_rmse(intr, k_idx, R0, t0, X0, *obs)
    kw = dict(tp_cap=8, dense_cg=True) if dense else {}
    R1, t1, X1, costs = tlm.ba_solve(intr, k_idx, R0, t0, X0, *obs, fixed, iters=25,
                                     cg_iters=40, **kw)
    rmse1 = tlm.reprojection_rmse(intr, k_idx, R1, t1, X1, *obs)
    assert float(rmse0) > 1.0
    assert float(rmse1) < 0.05
    assert float(costs[-1]) < float(costs[0]) * 1e-4


def test_ba_noise_floor():
    noise = 0.5
    sc = make_scene(n_cams=6, n_points=80, noise_px=noise)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    C = 6
    intr = T(np.asarray(sc.intrinsics, np.float32)[None])
    k_idx = torch.zeros(C, dtype=torch.int32)
    fixed = torch.zeros(C, dtype=torch.bool)
    fixed[0] = True
    obs = (T(cam_id), T(pt_id), T(uv), T(w))
    R1, t1, X1, _ = tlm.ba_solve(intr, k_idx, T(sc.Rs.astype(np.float32)),
                                 T(sc.ts.astype(np.float32)), T(sc.points.astype(np.float32)),
                                 *obs, fixed, iters=15, cg_iters=40)
    rmse = tlm.reprojection_rmse(intr, k_idx, R1, t1, X1, *obs)
    ref = jlm.reprojection_rmse(jnp.asarray(intr.numpy()), jnp.zeros(C, jnp.int32),
                                jnp.asarray(R1.numpy()), jnp.asarray(t1.numpy()),
                                jnp.asarray(X1.numpy()), cam_id, pt_id, jnp.asarray(uv),
                                jnp.asarray(w))
    np.testing.assert_allclose(float(rmse), float(ref), rtol=1e-4)
    assert float(rmse) < 1.2 * noise
