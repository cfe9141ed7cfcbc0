"""P3P parity: ``quartic_roots`` and ``p3p_minimal`` against ``sfmx``'s,
RANSAC with 4 candidates per sample at a low inlier ratio, and the gather
path with ``pnp_solver="p3p"`` — the same numpy inputs (and the reference's
RANSAC noise, injected) through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sfmx.core import se3 as jse3
from sfmx.localize.localize import LocalizationMap as JMap
from sfmx.localize.localize import localize_batch as jlocalize_batch
from sfmx.solvers import p3p as jp3p
from sfmx.solvers import pnp as jpnp
from sfmx.solvers import ransac as jransac
from sfmx_torch.localize.localize import LocalizationMap, localize_batch
from sfmx_torch.solvers import p3p as tp3p
from sfmx_torch.solvers import pnp as tpnp
from sfmx_torch.solvers import ransac as transac
from tests.test_torch_localize import INTR, _queries, _tripwire_like_map

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _exact_instances(rng, n_inst, n=3):
    """Random poses + world points in front of the camera (drawn in the
    camera frame, mapped back), with their normalized projections."""
    Rs, ts, Xs, xs = [], [], [], []
    for _ in range(n_inst):
        q = rng.standard_normal(4)
        R = np.asarray(jse3.quat_to_rot(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))
        t = rng.standard_normal(3).astype(np.float32)
        Xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                       rng.uniform(1.0, 6.0, n)], 1).astype(np.float32)
        Rs.append(R)
        ts.append(t)
        Xs.append(((Xc - t) @ R).astype(np.float32))
        xs.append((Xc[:, :2] / Xc[:, 2:3]).astype(np.float32))
    return np.stack(Rs), np.stack(ts), np.stack(Xs), np.stack(xs)


def test_quartic_roots_match_reference(rng):
    """Quartics with 4 well-separated real roots: the port's roots within
    1e-4 of the reference's and 5e-3 of numpy's (the reference test's
    tolerance); quartics with complex pairs: finite, every real root of the
    input represented within 1e-2."""
    coeffs, roots = [], []
    while len(coeffs) < 40:
        r = np.sort(rng.uniform(-3, 3, 4))
        if np.min(np.diff(r)) < 1e-2:
            continue
        coeffs.append(np.poly(r).astype(np.float32) * np.float32(rng.uniform(0.2, 5.0)))
        roots.append(r)
    coeffs = np.stack(coeffs)
    ref = np.asarray(jax.vmap(jp3p.quartic_roots)(jnp.asarray(coeffs)))
    out = tp3p.quartic_roots(T(coeffs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(np.sort(out, axis=1), np.stack(roots), atol=5e-3)
    cplx = rng.standard_normal((20, 5)).astype(np.float32)
    got = tp3p.quartic_roots(T(cplx)).numpy()
    assert np.isfinite(got).all()
    for c, g in zip(cplx, got):
        for rr in np.roots(c):
            if abs(rr.imag) < 1e-6:
                assert np.min(np.abs(g - rr.real)) < 1e-2, (g, rr)


def test_p3p_minimal_matches_reference(rng):
    """60 exact instances in one batch: every candidate the reference
    recovers the true pose with (error < 5e-3) is the port's same-index
    candidate, R within 1e-4 and t within 1e-3 (t = mean(Y) - R mean(X)
    with |X| up to ~8 amplifies f32 last-bit differences of the closed
    form: the port's cube root is a pow, the 3x3 depth solves pivot on
    another library's LU), and the port recovers every instance."""
    R, t, X, xn = _exact_instances(rng, 60)
    Rr, tr = (np.asarray(x) for x in jax.vmap(jp3p.p3p_minimal)(jnp.asarray(xn), jnp.asarray(X)))
    Ro, to = (x.numpy() for x in tp3p.p3p_minimal(T(xn), T(X)))
    assert Ro.shape == (60, 4, 3, 3) and to.shape == (60, 4, 3)
    err_r = (np.linalg.norm(Rr - R[:, None], axis=(2, 3))
             + np.linalg.norm(tr - t[:, None], axis=2))
    err_o = (np.linalg.norm(Ro - R[:, None], axis=(2, 3))
             + np.linalg.norm(to - t[:, None], axis=2))
    good = err_r < 5e-3
    assert good.any(axis=1).all() and (err_o.min(axis=1) < 5e-3).all()
    np.testing.assert_allclose(Ro[good], Rr[good], atol=1e-4)
    np.testing.assert_allclose(to[good], tr[good], atol=1e-3)


def test_p3p_ransac_low_inlier_ratio_matches_reference(rng):
    """25% inliers among 64 correspondences: RANSAC with 3-point samples
    and 4 candidates each, the reference's noise injected, finds the same
    best inlier count (all 16 inliers) and the true pose on both sides."""
    R, t, X_in, xn_in = (x[0] for x in _exact_instances(rng, 1, n=64))
    X = X_in.copy()
    n_out = 48
    X[:n_out] = rng.uniform(-3, 3, (n_out, 3)).astype(np.float32)   # 75% outliers
    xn = xn_in
    mask = np.ones(64, bool)
    thr = (1.0 / 500.0) ** 2

    def jres(model, xn_, X_):
        r = jpnp.pnp_residual(model[0], model[1], xn_, X_)
        return jnp.sum(r * r, axis=-1)

    def tres(model, xn_, X_):
        r = tpnp.pnp_residual(model[0], model[1], xn_, X_)
        return torch.sum(r * r, dim=-1)

    key = jax.random.PRNGKey(3)
    (Rr, tr), inl_r, cnt_r = jransac.ransac(
        key, jp3p.p3p_minimal, jres, (jnp.asarray(xn), jnp.asarray(X)), jnp.asarray(mask),
        k_hypotheses=512, sample_size=3, inlier_threshold=thr, n_candidates=4)
    g = np.asarray(jax.random.gumbel(key, (512, 64)))
    (Ro, to), inl_o, cnt_o = transac.ransac(
        T(g), tp3p.p3p_minimal, tres, (T(xn), T(X)), T(mask), sample_size=3,
        inlier_threshold=thr, n_candidates=4)
    assert int(cnt_o) == int(cnt_r) == 64 - n_out
    np.testing.assert_array_equal(inl_o.numpy(), np.asarray(inl_r))
    np.testing.assert_allclose(Ro.numpy(), R, atol=2e-3)
    np.testing.assert_allclose(to.numpy(), t, atol=2e-3)


def test_localize_batch_p3p_matches_reference():
    """The gather path with pnp_solver="p3p" and the reference's noise:
    n_inliers equal, pose atol 1e-4."""
    rng = np.random.default_rng(17)
    cols = _tripwire_like_map(rng)
    B, K, kh = 2, 256, 128
    q_desc, q_uv, q_mask = _queries(rng, cols, B, K)
    key = jax.random.PRNGKey(4)
    kw = dict(k_hypotheses=kh, m_cap=512, top_k_kf=4, pnp_solver="p3p")
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    ref = jlocalize_batch(jmap, jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask),
                          jnp.asarray(INTR), key, **kw)
    gum = np.stack([np.asarray(jax.random.gumbel(k_, (kh, K)))
                    for k_ in jax.random.split(key, B)])
    out = localize_batch(LocalizationMap.from_numpy(cols, "cpu"), T(q_desc), T(q_uv),
                         T(q_mask), T(INTR), gumbel=T(gum), **kw)
    np.testing.assert_array_equal(out.n_inliers.numpy(), np.asarray(ref.n_inliers))
    assert (out.n_inliers.numpy() > 100).all()
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
