"""``sfmx_torch.solvers.triangulate``, the rest of ``epipolar``, ``umeyama``
and the SE(3) / camera helpers of the reconstruction path against ``sfmx`` on
the same numpy inputs.

Tolerances, and why:
- triangulation: the reference takes the null vector of the 4x4 normal
  matrix by ``eigh``, the port by Cholesky + inverse iteration; both recover
  a point ~6 units away to 1e-3 on noiseless rays and within 2e-3 of each
  other with 0.3 px noise (the matrix's conditioning, not the method);
- ``eight_point``: both are LAPACK SVDs of the same f32 system: sign-aligned
  entries within 1e-4 of a unit-norm matrix;
- ``decompose_essential`` / ``relative_pose_from_essential``: R, t within
  1e-4 after the SVD's sign freedom is removed by comparing R and +-t;
- ``umeyama`` / ``ate_rmse``: closed form, within 1e-5;
- SE(3) helpers and ``reprojection_residual``: the same formulas, 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.core import cameras as jcam
from sfmx.core import se3 as jse3
from sfmx.solvers import epipolar as je
from sfmx.solvers import triangulate as jtri
from sfmx.solvers import umeyama as jum
from sfmx_torch.core import cameras as tcam
from sfmx_torch.core import se3 as tse3
from sfmx_torch.solvers import epipolar as te
from sfmx_torch.solvers import triangulate as ttri
from sfmx_torch.solvers import umeyama as tum
from tests.synthetic import make_scene

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _tracks(noise_px, V=5, N=120, seed=0):
    """N points seen by V of 6 cameras: Ps (N,V,3,4), xns (N,V,2), mask."""
    sc = make_scene(n_cams=6, n_points=N, noise_px=noise_px, seed=seed)
    rng = np.random.default_rng(seed)
    cams = np.stack([rng.permutation(6)[:V] for _ in range(N)])
    P_all = np.concatenate([sc.Rs, sc.ts[:, :, None]], axis=2).astype(np.float32)
    k = sc.intrinsics.astype(np.float32)
    xn = (sc.uv - k[2:4]) / k[0:2]
    xns = xn[cams, np.arange(N)[:, None]].astype(np.float32)
    mask = rng.random((N, V)) < 0.8
    mask[:, :2] = True
    mask[:3] = np.array([[True] + [False] * (V - 1)] * 3)       # too few views
    return sc, P_all[cams], xns, mask


@pytest.mark.parametrize("noise_px", [0.0, 0.3])
def test_triangulate_nview_matches_reference(noise_px):
    sc, Ps, xns, mask = _tracks(noise_px)
    Xr, okr = jtri.triangulate_nview_b(jnp.asarray(Ps), jnp.asarray(xns), jnp.asarray(mask))
    X, ok = ttri.triangulate_nview_b(T(Ps), T(xns), T(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okr))
    good = np.asarray(okr)
    assert np.abs(X.numpy()[good] - np.asarray(Xr)[good]).max() < 2e-3
    if noise_px == 0.0:
        assert np.abs(X.numpy()[good] - sc.points[good]).max() < 1e-3
    # one track, no batch axis
    X1, ok1 = ttri.triangulate_nview(T(Ps[10]), T(xns[10]), T(mask[10]))
    assert X1.shape == (3,) and bool(ok1)
    np.testing.assert_allclose(X1.numpy(), X.numpy()[10], atol=1e-5)


def _pair(noise_px=0.3, a=1, b=3):
    sc = make_scene(n_cams=6, n_points=150, noise_px=noise_px, seed=2)
    k = sc.intrinsics.astype(np.float32)
    both = sc.visible[a] & sc.visible[b]
    xa = ((sc.uv[a] - k[2:4]) / k[0:2])[both].astype(np.float32)
    xb = ((sc.uv[b] - k[2:4]) / k[0:2])[both].astype(np.float32)
    Rrel = sc.Rs[b] @ sc.Rs[a].T
    trel = sc.ts[b] - Rrel @ sc.ts[a]
    return xa, xb, Rrel.astype(np.float32), (trel / np.linalg.norm(trel)).astype(np.float32)


def test_two_view_cheirality_parallax_match_reference():
    xa, xb, Rrel, trel = _pair(0.0)
    I3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Xr, okr = jtri.triangulate_two_view(*map(jnp.asarray, (I3, z3, Rrel, trel, xa, xb)))
    X, ok = ttri.triangulate_two_view(*map(T, (I3, z3, Rrel, trel, xa, xb)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okr))
    assert ok.all() and np.abs(X.numpy() - np.asarray(Xr)).max() < 2e-3
    # a batch of second cameras: the true one and its mirror (points behind)
    R2 = np.stack([Rrel, Rrel])
    t2 = np.stack([trel, -trel])
    Xb, okb = ttri.triangulate_two_view(T(I3), T(z3), T(R2), T(t2), T(xa), T(xb))
    assert Xb.shape == (2, len(xa), 3) and okb[0].all() and not okb[1].any()
    np.testing.assert_array_equal(
        ttri.cheirality(T(Rrel), T(trel), X).numpy(),
        np.asarray(jtri.cheirality(jnp.asarray(Rrel), jnp.asarray(trel), Xr)))
    c2 = -Rrel.T @ trel
    par = ttri.parallax_deg(T(z3), T(c2), X)
    np.testing.assert_allclose(par.numpy(), np.asarray(
        jtri.parallax_deg(jnp.asarray(z3), jnp.asarray(c2), Xr)), atol=1e-2)


def _align(M, ref):
    s = np.sign(np.sum(M * ref, axis=(-2, -1), keepdims=True))
    return M * np.where(s == 0, 1.0, s)


@pytest.mark.parametrize("essential", [True, False])
@pytest.mark.parametrize("n", [8, 60])
def test_eight_point_matches_reference(essential, n):
    xa, xb, _, _ = _pair()
    mask = np.ones(n, bool)
    if n > 8:
        mask[::7] = False
    Fr = np.asarray(je.eight_point(jnp.asarray(xa[:n]), jnp.asarray(xb[:n]), jnp.asarray(mask),
                                   essential=essential))
    F = te.eight_point(T(xa[:n]), T(xb[:n]), T(mask), essential=essential).numpy()
    assert np.abs(_align(F, Fr) - Fr).max() < 1e-4
    # batched over samples: rows equal to the single calls
    Fb = te.eight_point(T(np.stack([xa[:n], xa[8:8 + n]])), T(np.stack([xb[:n], xb[8:8 + n]])),
                        T(np.stack([mask, mask])), essential=essential).numpy()
    np.testing.assert_allclose(Fb[0], F, atol=1e-6)
    sv = np.linalg.svd(Fb[1], compute_uv=False)
    assert sv[2] < 1e-6 and (not essential or abs(sv[0] - sv[1]) < 1e-5)


def test_eight_point_degenerate_sample_is_rejected():
    """A non-finite system gives F = 0, whose Sampson error is inf."""
    x = np.full((8, 2), np.nan, np.float32)
    F = te.eight_point(T(x), T(x), torch.ones(8, dtype=torch.bool), essential=True)
    assert float(F.abs().max()) == 0.0
    xa, xb, _, _ = _pair()
    assert torch.isinf(te.sampson_error(F, T(xa), T(xb))).all()


def test_relative_pose_matches_reference():
    xa, xb, Rrel, trel = _pair()
    mask = np.ones(len(xa), bool)
    E = je.eight_point(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mask), essential=True)
    Rs_r, ts_r = je.decompose_essential(E)
    Rs, ts = te.decompose_essential(T(E))
    # the SVD leaves t's sign and the order of the two rotations free
    for i in range(4):
        d = [np.abs(Rs[i].numpy() - np.asarray(Rs_r[j])).max()
             + min(np.abs(ts[i].numpy() - s * np.asarray(ts_r[j])).max() for s in (1, -1))
             for j in range(4)]
        assert min(d) < 2e-4
    Rr, tr, nr, Xr = je.relative_pose_from_essential(E, jnp.asarray(xa), jnp.asarray(xb),
                                                     jnp.asarray(mask))
    R, t, n, X = te.relative_pose_from_essential(T(E), T(xa), T(xb), T(mask))
    assert int(n) == int(nr) == len(xa)
    assert np.abs(R.numpy() - np.asarray(Rr)).max() < 1e-4
    assert np.abs(t.numpy() - np.asarray(tr)).max() < 1e-4
    assert np.abs(R.numpy() - Rrel).max() < 5e-3 and np.abs(t.numpy() - trel).max() < 2e-2
    assert np.abs(X.numpy() - np.asarray(Xr)).max() < 5e-3


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_matches_reference(with_scale):
    rng = np.random.default_rng(0)
    src = rng.standard_normal((40, 3)).astype(np.float32)
    Rg = np.asarray(jse3.so3_exp(jnp.asarray([0.3, -0.5, 0.2], jnp.float32)))
    dst = (1.7 * src @ Rg.T + np.array([1.0, -2.0, 0.5])
           + 0.01 * rng.standard_normal((40, 3))).astype(np.float32)
    mask = rng.random(40) < 0.8
    sr, Rr, tr = jum.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), with_scale)
    s, R, t = tum.umeyama(T(src), T(dst), T(mask), with_scale)
    np.testing.assert_allclose(float(s), float(sr), rtol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tr), atol=1e-5)
    np.testing.assert_allclose(tum.apply_sim3(s, R, t, T(src)).numpy(),
                               np.asarray(jum.apply_sim3(sr, Rr, tr, jnp.asarray(src))), atol=1e-4)
    rr, _ = jum.ate_rmse(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), with_scale)
    r, (s2, R2, t2) = tum.ate_rmse(T(src), T(dst), T(mask), with_scale)
    np.testing.assert_allclose(float(r), float(rr), rtol=1e-4, atol=1e-6)
    r_all, _ = tum.ate_rmse(T(src), T(dst), with_scale=with_scale)
    assert float(r_all) < 0.05 if with_scale else float(r_all) > 0.1
    # a reflection in the data still gives a proper rotation
    _, Rm, _ = tum.umeyama(T(src), T(dst * np.array([1.0, 1.0, -1.0], np.float32)))
    assert abs(float(torch.linalg.det(Rm)) - 1.0) < 1e-5


def test_se3_helpers_match_reference():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    Ra, Rb = (np.asarray(jse3.so3_exp_b(jnp.asarray(0.4 * x))) for x in (w, w[::-1].copy()))
    ta, tb = rng.standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.so3_exp_b(T(0.4 * w)).numpy(), Ra, atol=1e-6)
    delta = 0.1 * rng.standard_normal((5, 6)).astype(np.float32)
    Rp, tp = jse3.perturb_b(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(delta))
    R2, t2 = tse3.perturb_b(T(Ra), T(ta), T(delta))
    np.testing.assert_allclose(R2.numpy(), np.asarray(Rp), atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(tp), atol=1e-6)
    # a leading candidate axis broadcasts: (4,1,1) step scales of one update
    al = torch.tensor([1.0, 0.5, 0.25, 0.0625])[:, None, None]
    R4, t4 = tse3.perturb_b(T(Ra), T(ta), al * T(delta))
    assert R4.shape == (4, 5, 3, 3) and t4.shape == (4, 5, 3)
    np.testing.assert_allclose(R4[0].numpy(), np.asarray(Rp), atol=1e-6)
    for i in range(5):
        Rc, tc = jse3.compose(*map(jnp.asarray, (Ra[i], ta[i], Rb[i], tb[i])))
        Ri, ti = jse3.inverse(jnp.asarray(Ra[i]), jnp.asarray(ta[i]))
        got = tse3.compose(T(Ra[i]), T(ta[i]), T(Rb[i]), T(tb[i]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(Rc), atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(tc), atol=1e-6)
        inv = tse3.inverse(T(Ra[i]), T(ta[i]))
        np.testing.assert_allclose(inv[0].numpy(), np.asarray(Ri), atol=1e-6)
        np.testing.assert_allclose(inv[1].numpy(), np.asarray(ti), atol=1e-6)
    cb = tse3.compose(T(Ra), T(ta), T(Rb), T(tb))                    # batched
    assert cb[0].shape == (5, 3, 3) and cb[1].shape == (5, 3)
    X = rng.standard_normal((7, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.apply(T(Ra[0]), T(ta[0]), T(X)).numpy(),
                               np.asarray(jse3.apply(jnp.asarray(Ra[0]), jnp.asarray(ta[0]),
                                                     jnp.asarray(X))), atol=1e-6)


def test_reprojection_residual_matches_reference():
    sc = make_scene(n_cams=4, n_points=50, noise_px=0.5, seed=4)
    k = sc.intrinsics.astype(np.float32).copy()
    k[4:] = [0.05, -0.01, 0.002]
    cam = np.repeat(np.arange(4), 50)
    pt = np.tile(np.arange(50), 4)
    args = (np.tile(k, (200, 1)), sc.Rs[cam].astype(np.float32), sc.ts[cam].astype(np.float32),
            sc.points[pt].astype(np.float32), sc.uv[cam, pt].astype(np.float32))
    ref = jax.vmap(jcam.reprojection_residual)(*map(jnp.asarray, args))
    got = tcam.reprojection_residual(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
