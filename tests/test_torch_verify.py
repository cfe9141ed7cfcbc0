"""Geometric verification: the port's batched epipolar pieces and
``geometric_verify_pairs`` against ``sfmx``'s on the same numpy inputs,
with the reference's own Gumbel draws injected
(``jax.vmap(lambda k: jax.random.gumbel(k, (H, K)))(jax.random.split(key, Np))``).

Tolerances, and why:
- ``eight_point_batch``: the damped Cholesky squares the conditioning of the
  8-point system (~3 f32 digits lost), and the two sides sum the normal
  matrix in other orders: sign-aligned F entries within 1e-4 at the median
  of a batch of refits (5e-3 for minimal samples), algebraic residuals no
  more than 10% above the reference's at the median;
- ``enforce_essential_batch``: E within 1e-5 (the (s,s,0) projection is
  unique; both SVDs are LAPACK's);
- ``sampson_error_batch``: rtol 1e-4 / atol 1e-10, inf on the same entries;
- inlier masks equal except where the match's squared Sampson error under
  the kept model lies within 1% of the threshold, counts within the number
  of such matches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.core import cameras as jcam
from sfmx.kernels import matching as jm
from sfmx.solvers import epipolar as je
from sfmx_torch.kernels import matching as tm
from sfmx_torch.solvers import epipolar as te
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)
THR = (2.0 / 520.0) ** 2


def T(a):
    return torch.from_numpy(np.array(a))


def _two_view(rng, B, N, noise=0.0):
    """B random calibrated two-view problems of N correspondences each
    (normalized coordinates, points 3-8 m in front, ~0.5 m baselines)."""
    X = rng.uniform(-2, 2, (B, N, 3))
    X[..., 2] = rng.uniform(3, 8, (B, N))
    ang = rng.normal(0, 0.05, (B, 3))
    Rs = []
    for a in ang:
        K_ = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        Rs.append(np.eye(3) + np.sin(np.linalg.norm(a)) / max(np.linalg.norm(a), 1e-12) * K_)
    R = np.stack(Rs)
    t = rng.normal(0, 0.3, (B, 3))
    X2 = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    x1 = X[..., :2] / X[..., 2:]
    x2 = X2[..., :2] / X2[..., 2:]
    x1 = x1 + noise * rng.normal(size=x1.shape)
    return x1.astype(np.float32), x2.astype(np.float32)


def _sign_aligned(F, G):
    s = np.sign(np.sum(F * G, axis=(1, 2)))
    return G * s[:, None, None]


def _finite(F):
    """Solves that did not break down: finite, and not collapsed to F = 0."""
    return np.isfinite(F).all(axis=(1, 2)) & (np.abs(np.nan_to_num(F)).max(axis=(1, 2)) > 0)


@pytest.mark.parametrize("N,noise,weighted,tol", [(8, 1e-3, False, 5e-3),
                                                  (40, 2e-3, True, 1e-4)])
def test_eight_point_batch_matches_reference(rng, N, noise, weighted, tol):
    """Noisy minimal samples (N=8, w=1) and weighted refits over 40 noisy
    points with zero weights mixed in: where neither side broke down (>= 90%
    of the batch; see the breakdown test below) the sign-aligned F entries
    agree at the median within ``tol`` (5e-3 for minimal samples, whose
    normal matrix is rank 8 up to the noise, so two f32 inverse iterations
    land at different points of a near-null plane; 1e-4 for refits), and
    the port's algebraic residuals are at the median no more than 10% above
    the reference's."""
    x1, x2 = _two_view(rng, 256, N, noise=noise)
    w = (rng.random((256, N)) > 0.2).astype(np.float32) if weighted \
        else np.ones((256, N), np.float32)
    Fj = np.asarray(je.eight_point_batch(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    Ft = te.eight_point_batch(T(x1), T(x2), T(w)).numpy()
    fin = _finite(Fj) & _finite(Ft)
    assert fin.mean() >= 0.9
    d = np.abs(Fj - _sign_aligned(Fj, Ft)).max(axis=(1, 2))[fin]
    assert np.median(d) <= tol, np.quantile(d, [0.5, 0.95])
    p1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    p2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    rj, rt = (np.abs(np.einsum("bni,bij,bnj,bn->bn", p2, F, p1, w)).max(axis=1)[fin]
              for F in (Fj, Ft))
    assert np.median(rt) <= 1.1 * np.median(rj), (np.median(rt), np.median(rj))
    np.testing.assert_allclose(np.linalg.norm(Ft[fin], axis=(1, 2)), 1.0, atol=1e-5)


def test_exact_minimal_sample_breakdown_is_rejected(rng):
    """Exact 8-point samples make the normal matrix exactly rank 8, so the
    damped f32 Cholesky's last pivot is rounding noise: on either side a few
    percent of the solves break down (a pivot floored at 1e-30; F comes out
    0 or not finite), and not the same ones (ROADMAP queue 3, F4).  Such an
    F scores inf Sampson error on every point on both sides, so RANSAC
    never counts it."""
    x1, x2 = _two_view(rng, 256, 8)
    w = np.ones((256, 8), np.float32)
    Fj = np.asarray(je.eight_point_batch(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    Ft = te.eight_point_batch(T(x1), T(x2), T(w)).numpy()
    assert _finite(Fj).mean() >= 0.9 and _finite(Ft).mean() >= 0.9
    y1, y2 = _two_view(rng, 256, 20, noise=1e-3)
    ej = np.asarray(je.sampson_error_batch(jnp.asarray(Fj), jnp.asarray(y1), jnp.asarray(y2)))
    et = te.sampson_error_batch(T(Ft), T(y1), T(y2)).numpy()
    assert np.isinf(ej[~_finite(Fj)]).all() and np.isinf(et[~_finite(Ft)]).all()
    assert not (ej < THR)[~_finite(Fj)].any() and not (et < THR)[~_finite(Ft)].any()


def test_chol9_solve_matches_reference(rng):
    """The damped 9x9 solve on well-conditioned SPD normal matrices: x
    within 1e-4 relative of the reference's component-wise solve."""
    A = rng.normal(size=(64, 12, 9)).astype(np.float32)
    M = np.einsum("bni,bnj->bij", A, A).astype(np.float32)
    b = rng.normal(size=(64, 9)).astype(np.float32)
    xj = je._chol9_solve([[jnp.asarray(M[:, i, j]) for j in range(9)] for i in range(9)],
                         [jnp.asarray(b[:, i]) for i in range(9)])
    xj = np.stack([np.asarray(c) for c in xj], axis=1)
    xt = te._chol9_solve(T(M), T(b)).numpy()
    scale = np.abs(xj).max(axis=1, keepdims=True)
    assert np.all(np.isfinite(xt))
    np.testing.assert_allclose(xt / scale, xj / scale, atol=1e-4)


def test_enforce_essential_and_sampson_match_reference(rng):
    """(s,s,0) projection and Sampson errors, a zero F included (its errors
    are inf on both sides: a degenerate model rejects)."""
    x1, x2 = _two_view(rng, 64, 8)
    x1 = x1 + 1e-3 * rng.normal(size=x1.shape).astype(np.float32)
    F = np.array(je.eight_point_batch(jnp.asarray(x1), jnp.asarray(x2), jnp.ones((64, 8))))
    F[5] = 0.0
    Ej = np.asarray(je.enforce_essential_batch(jnp.asarray(F)))
    Et = te.enforce_essential_batch(T(F)).numpy()
    np.testing.assert_allclose(Et, Ej, atol=1e-5)
    s = np.linalg.svd(Et[:5], compute_uv=False)
    np.testing.assert_allclose(s[:, 0], s[:, 1], rtol=1e-4)
    y1, y2 = _two_view(rng, 64, 50, noise=1e-3)
    ej = np.asarray(je.sampson_error_batch(jnp.asarray(F), jnp.asarray(y1), jnp.asarray(y2)))
    et = te.sampson_error_batch(T(F), T(y1), T(y2)).numpy()
    np.testing.assert_array_equal(np.isinf(et), np.isinf(ej))
    fin = np.isfinite(ej)
    np.testing.assert_allclose(et[fin], ej[fin], rtol=1e-4, atol=1e-10)
    assert np.isinf(et[5]).all()
    e1 = te.sampson_error(T(F[0]), T(y1[0]), T(y2[0])).numpy()
    np.testing.assert_allclose(e1, np.asarray(je.sampson_error(jnp.asarray(F[0]),
                                                               jnp.asarray(y1[0]),
                                                               jnp.asarray(y2[0]))),
                               rtol=1e-4, atol=1e-10)


def test_enforce_essential_non_finite_rows_give_nan(rng):
    """F5: a non-finite F (a broken-down refit) gives a NaN E on both sides,
    where ``torch.linalg.svd`` alone raises for the whole batch; the finite
    rows are unaffected (atol 1e-5, as above) and a zero F stays zero."""
    x1, x2 = _two_view(rng, 6, 12, noise=1e-3)
    F = np.array(je.eight_point_batch(jnp.asarray(x1), jnp.asarray(x2), jnp.ones((6, 12))))
    F[0] = np.nan
    F[2, 1, 1] = np.inf
    F[4] = 0.0
    with pytest.raises(RuntimeError):
        torch.linalg.svd(T(F))
    Ej = np.asarray(je.enforce_essential_batch(jnp.asarray(F)))
    Et = te.enforce_essential_batch(T(F)).numpy()
    bad = np.array([True, False, True, False, False, False])
    assert np.isnan(Ej[bad]).all() and np.isnan(Et[bad]).all()
    np.testing.assert_allclose(Et[~bad], Ej[~bad], atol=1e-5)
    assert np.all(Et[4] == 0.0)


def _verify_case(rng):
    """test_matching_tracks' multi-pair case: 5 cameras, all 10 pairs; pair 3
    re-pointed at random targets (pure outliers), pair 7 cut to 5 valid
    matches (below the minimal sample)."""
    sc = make_scene(n_cams=5, n_points=200)
    uv, desc, mask, feat_pt = scene_features(sc, rng)
    intr = jnp.asarray(sc.intrinsics, jnp.float32)
    xn = np.asarray(jax.vmap(lambda u: jcam.pixel_to_normalized(intr, u))(jnp.asarray(uv)))
    pairs = np.array([(a, b) for a in range(5) for b in range(a + 1, 5)], np.int32)
    res = jm.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    idx = np.array(res.idx)
    valid = np.array(res.valid)
    nb1 = int(mask[pairs[3, 1]].sum())
    idx[3] = rng.integers(0, nb1, size=idx.shape[1])
    keep = np.where(valid[7])[0][:5]
    valid[7] = False
    valid[7, keep] = True
    return xn, mask, pairs, idx, valid, np.array(res.score), feat_pt


@pytest.mark.parametrize("H,seed", [(256, 1), (64, 5)])
def test_geometric_verify_pairs_matches_reference_with_injected_draws(rng, H, seed):
    """The port with the reference's Gumbel draws injected: inlier masks
    equal outside the 1% threshold band, counts within its slack; the real
    pairs keep > 30 true inliers, the corrupted and the degenerate pair
    almost nothing."""
    xn, mask, pairs, idx, valid, score, feat_pt = _verify_case(rng)
    Np, K = idx.shape
    key = jax.random.PRNGKey(seed)
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (H, K)))(jax.random.split(key, Np)))
    jres = jm.MatchResult(jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(score))
    jinl, jcnt = (np.asarray(x) for x in jm.geometric_verify_pairs(
        key, jnp.asarray(xn), jnp.asarray(mask), jnp.asarray(pairs), jres, threshold=THR,
        k_hypotheses=H))
    tres = tm.MatchResult(T(idx).long(), T(valid), T(score))
    args = (T(g), T(xn), T(mask), pairs, tres)
    tinl, tcnt = (x.numpy() for x in tm.geometric_verify_pairs(*args, threshold=THR))
    err, _ = tm.geometric_verify_errors(*args, threshold=THR)
    band = (np.abs(err.numpy() / THR - 1.0) < 0.01)
    np.testing.assert_array_equal(tinl[~band], jinl[~band])
    assert np.all(np.abs(tcnt - jcnt) <= band.sum(axis=1))
    np.testing.assert_array_equal(tcnt, tinl.sum(axis=1))
    for p in (0, 1, 2, 4, 5, 6, 8, 9):
        a, b = pairs[p]
        good = feat_pt[a][tinl[p]] == feat_pt[b][idx[p][tinl[p]]]
        assert tcnt[p] > 30 and good.mean() > 0.95, (p, tcnt[p], good.mean())
    assert tcnt[3] < 32 and tcnt[7] <= 5


def test_geometric_verify_rejects_bad_matches(rng):
    """test_matching_tracks' single-pair case on the port alone (its own
    noise): surviving matches are overwhelmingly true, a third corrupted at
    random targets gets rejected."""
    sc = make_scene(n_cams=2, n_points=200)
    uv, desc, mask, feat_pt = scene_features(sc, rng)
    xn = T(np.asarray(jax.vmap(lambda u: jcam.pixel_to_normalized(
        jnp.asarray(sc.intrinsics, jnp.float32), u))(jnp.asarray(uv))))
    pairs = np.array([[0, 1]], np.int32)
    res = tm.match_pairs_float(T(desc), T(mask), pairs)
    idx = res.idx.clone()
    vsel = torch.nonzero(res.valid[0])[:, 0].numpy()
    bad = rng.permutation(vsel)[: len(vsel) // 3]
    idx[0, bad] = T(rng.integers(0, mask[1].sum(), size=len(bad)))
    from sfmx_torch.solvers.ransac import gumbel_noise

    g = gumbel_noise((1, 256, idx.shape[1]), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    inl, _ = tm.geometric_verify_pairs(g, xn, T(mask), pairs,
                                       tm.MatchResult(idx, res.valid, res.score), threshold=THR)
    inl = inl.numpy()[0]
    good_kept = feat_pt[0][inl] == feat_pt[1][idx[0].numpy()[inl]]
    assert good_kept.mean() > 0.95
    assert inl[bad].mean() < 0.1
