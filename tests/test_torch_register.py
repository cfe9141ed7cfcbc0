"""Verified similarity registration on the CPU: ``sfmx_torch.recon.register``
against ``sfmx.recon.register`` on the same numpy inputs, with the
reference's Gumbel draws injected draw by draw (``jax_draws``).

Tolerances, and why:
- the RANSAC runs the same minimal samples on both sides; its hypotheses
  come from two SVDs (LAPACK through jax and through torch) that round
  differently, so an inlier decision could only differ for a residual
  within rounding of the threshold: the inlier masks are required equal;
- the final model is the same numpy Umeyama on the same inliers: s, R, t
  within 1e-5 (equal in practice);
- the host-numpy helpers (``_umeyama_np``, ``_sim3_diff``,
  ``match_landmark_pairs``, ``cross_reprojection_px``,
  ``register_rigid_anchored``) are copies and compare exactly.
"""
import jax
import numpy as np
import pytest
import torch

from sfmx.recon import register as jreg
from sfmx_torch.recon import register as treg
from tests.synthetic import make_scene
from tests.test_merge import _session

torch.set_num_threads(2)


def jax_draws(key):
    """A noise callable that yields the reference's per-attempt draws:
    ``key, sk = jax.random.split(key)`` then ``jax.random.gumbel(sk, shape)``."""
    state = {"key": key}

    def draw(shape):
        state["key"], sk = jax.random.split(state["key"])
        return np.array(jax.random.gumbel(sk, shape))

    return draw


def port_scene_dict(st):
    """A reference session's scene as the numpy dict the gates take."""
    sc = st[0]
    return {"R": np.array(sc.cam_R), "t": np.array(sc.cam_t), "X": np.array(sc.X),
            "cam_k": np.array(sc.cam_k), "intr": np.array(sc.intr),
            "obs_cam": np.array(sc.obs_cam), "obs_pt": np.array(sc.obs_pt),
            "obs_uv": np.array(sc.obs_uv), "obs_alive": np.array(sc.obs_alive)}


def _rand_sim3(rng):
    s = float(rng.uniform(0.5, 2.0))
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return s, Q, rng.uniform(-3, 3, 3)


def _rand_rot(rng):
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _recover_case():
    rng = np.random.default_rng(3)
    Pb = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    s, R, t = _rand_sim3(rng)
    Pa = (s * (Pb @ R.T) + t).astype(np.float32)
    Pa += rng.normal(scale=0.002, size=Pa.shape).astype(np.float32)
    out = rng.random(200) < 0.2
    Pa[out] = rng.uniform(-5, 5, (int(out.sum()), 3))
    return Pa, Pb, (s, R, t), out


def _same_reg(got, ref):
    assert np.array_equal(got.inliers, np.asarray(ref.inliers))
    assert abs(got.s - ref.s) <= 1e-5 * abs(ref.s)
    np.testing.assert_allclose(got.R, np.asarray(ref.R), atol=1e-5)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), atol=1e-5)
    np.testing.assert_array_equal(got.pairs, np.asarray(ref.pairs))
    assert got.diag == ref.diag


def test_register_points_verified_recovers():
    Pa, Pb, (s, R, t), out = _recover_case()
    reg = treg.register_points_verified(Pa, Pb, device="cpu",
                                        noise=jax_draws(jax.random.PRNGKey(0)))
    assert abs(reg.s / s - 1.0) < 0.02
    assert np.allclose(reg.R, R, atol=0.02)
    assert reg.inliers.sum() >= 0.7 * (~out).sum()
    err = np.linalg.norm(reg.s * (Pb[reg.inliers] @ reg.R.T) + reg.t - Pa[reg.inliers], axis=1)
    assert np.median(err) < 0.05
    _same_reg(reg, jreg.register_points_verified(Pa, Pb, key=jax.random.PRNGKey(0)))
    # a generator draws its own samples and recovers the same similarity
    reg2 = treg.register_points_verified(Pa, Pb, device="cpu",
                                         noise=torch.Generator().manual_seed(5))
    assert abs(reg2.s / s - 1.0) < 0.02 and np.allclose(reg2.R, R, atol=0.02)


def test_register_points_verified_rejects_garbage():
    rng = np.random.default_rng(4)
    Pa = rng.uniform(-2, 2, (120, 3)).astype(np.float32)
    Pb = rng.uniform(-2, 2, (120, 3)).astype(np.float32)  # unrelated
    with pytest.raises(treg.RegistrationError) as ei:
        treg.register_points_verified(Pa, Pb, device="cpu",
                                      noise=jax_draws(jax.random.PRNGKey(1)))
    assert ei.value.attempts
    with pytest.raises(jreg.RegistrationError) as ej:
        jreg.register_points_verified(Pa, Pb, key=jax.random.PRNGKey(1))
    assert ei.value.attempts == ej.value.attempts
    assert str(ei.value) == str(ej.value)


def test_register_points_verified_too_few():
    with pytest.raises(treg.RegistrationError, match="too few correspondences"):
        treg.register_points_verified(np.zeros((2, 3), np.float32),
                                      np.zeros((2, 3), np.float32), device="cpu")


def test_registration_takes_no_default_device():
    with pytest.raises(TypeError):
        treg.register_points_verified(np.zeros((2, 3), np.float32),
                                      np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("case", ["recover", "garbage", "few_inliers", "unstable"])
def test_solve_sim3_gated_draw_for_draw(case):
    """The same (k, M) draw on both sides: same inliers, model within 1e-5,
    the same diagnostics (and so the same gate decisions)."""
    rng = np.random.default_rng(11)
    Pa, Pb, _, _ = _recover_case()
    kw = {}
    if case == "garbage":
        Pb = rng.uniform(-2, 2, Pa.shape).astype(np.float32)
    elif case == "few_inliers":
        kw = dict(min_inliers=180)
    elif case == "unstable":
        # a consistent set whose two halves disagree: 2 % noise on half the points
        Pa = Pa.copy()
        Pa[1::2] += rng.normal(scale=0.04, size=Pa[1::2].shape).astype(np.float32)
        kw = dict(inlier_frac_of_extent=0.2, agree_rot_deg=0.05)
    extent = float(np.linalg.norm(Pa.max(0) - Pa.min(0)))
    key = jax.random.PRNGKey(7)
    g = np.array(jax.random.gumbel(key, (512, len(Pa))))
    mj, inj, dj = jreg.solve_sim3_gated(key, Pa, Pb, extent=extent, k_hypotheses=512, **kw)
    mt, int_, dt = treg.solve_sim3_gated(torch.from_numpy(g), Pa, Pb, extent=extent, **kw)
    assert np.array_equal(int_, np.asarray(inj)) and dt == dj
    assert (mt is None) == (mj is None)
    if case == "recover":
        assert mt is not None
    else:
        assert mt is None and "fail" in dt
    if mt is not None:
        assert abs(mt[0] - mj[0]) <= 1e-5 * mj[0]
        np.testing.assert_allclose(mt[1], np.asarray(mj[1]), atol=1e-5)
        np.testing.assert_allclose(mt[2], np.asarray(mj[2]), atol=1e-5)


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((40, 3))
    s, R, t = _rand_sim3(rng)
    dst = s * src @ R.T + t + 0.01 * rng.standard_normal((40, 3))
    for a, b in zip(treg._umeyama_np(src, dst), jreg._umeyama_np(src, dst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    m1, m2 = treg._umeyama_np(src[::2], dst[::2]), treg._umeyama_np(src[1::2], dst[1::2])
    assert treg._sim3_diff(m1, m2, 3.0, src.mean(0)) == jreg._sim3_diff(m1, m2, 3.0, src.mean(0))
    da = rng.standard_normal((50, 16)).astype(np.float32)
    db = np.concatenate([da[10:40] + 0.05 * rng.standard_normal((30, 16)).astype(np.float32),
                         rng.standard_normal((20, 16)).astype(np.float32)])
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    aa, ab = rng.random(50) < 0.9, rng.random(50) < 0.9
    for th in (0.7, 0.6):
        got = treg.match_landmark_pairs(da, aa, db, ab, th)
        ref = jreg.match_landmark_pairs(da, aa, db, ab, th)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert len(got[0]) >= 20


@pytest.fixture(scope="module")
def overlapping_sessions():
    """The reference's two overlapping sessions (tests/test_merge.py)."""
    sc = make_scene(n_cams=12, n_points=300, noise_px=0.3, seed=5, arc_deg=150.0)
    rng = np.random.default_rng(0)
    return sc, _session(sc, (0, 7), rng), _session(sc, (5, 12), rng)


def test_cross_reprojection_px_matches_reference(overlapping_sessions):
    from sfmx.recon.merge import landmark_descriptors

    sc, s1, s2 = overlapping_sessions
    d1 = landmark_descriptors(s1[0], s1[1], s1[4])
    d2 = landmark_descriptors(s2[0], s2[1], s2[4])
    a1, a2 = np.array(s1[0].X_alive), np.array(s2[0].X_alive)
    ia, ib, _ = treg.match_landmark_pairs(d1, a1, d2, a2, 0.7)
    pairs = np.stack([ia, ib], axis=1)
    sa, sb = port_scene_dict(s1), port_scene_dict(s2)
    X1, X2 = np.array(s1[0].X), np.array(s2[0].X)
    model = treg._umeyama_np(X2[ib].astype(np.float64), X1[ia].astype(np.float64))
    for mdl, k in ((model, 4), (model, 2), ((1.3 * model[0], model[1], model[2] + 0.2), 4)):
        got = treg.cross_reprojection_px(mdl, pairs, sa, sb, max_obs_per_lm=k)
        ref = jreg.cross_reprojection_px(mdl, pairs, sa, sb, max_obs_per_lm=k)
        assert got == ref
    assert treg.cross_reprojection_px(model, pairs, sa, sb) < 2.0
    assert treg.cross_reprojection_px(model, pairs[:0], sa, sb) == float("inf")


def test_register_landmarks_verified_matches_reference(overlapping_sessions):
    """Descriptor candidates, RANSAC, the gates and cross-reprojection, with
    the reference's draws: the same verified attempt."""
    from sfmx.recon.merge import landmark_descriptors

    sc, s1, s2 = overlapping_sessions
    d1 = landmark_descriptors(s1[0], s1[1], s1[4])
    d2 = landmark_descriptors(s2[0], s2[1], s2[4])
    args = (np.array(s1[0].X), d1, np.array(s1[0].X_alive),
            np.array(s2[0].X), d2, np.array(s2[0].X_alive))
    sa, sb = port_scene_dict(s1), port_scene_dict(s2)
    got = treg.register_landmarks_verified(*args, scene_a=sa, scene_b=sb, device="cpu",
                                           noise=jax_draws(jax.random.PRNGKey(3)))
    ref = jreg.register_landmarks_verified(*args, scene_a=sa, scene_b=sb,
                                           key=jax.random.PRNGKey(3))
    _same_reg(got, ref)
    assert got.diag["verified"] and got.inliers.sum() >= 20 and got.diag["reproj_px"] < 2.0


@pytest.fixture(scope="module")
def disjoint_sessions():
    """Two sessions of DIFFERENT worlds with unrelated descriptor universes
    (the reference's fixture): there is no overlap, and registration must
    refuse, not hallucinate."""
    rng = np.random.default_rng(0)
    sc1 = make_scene(n_cams=8, n_points=300, noise_px=0.3, seed=5, arc_deg=150.0)
    sc2 = make_scene(n_cams=8, n_points=300, noise_px=0.3, seed=17, arc_deg=150.0)
    return (_session(sc1, (0, 8), rng, base_desc_seed=99),
            _session(sc2, (0, 8), rng, base_desc_seed=123))


def to_port_session(st):
    """A reference session (Scene, desc, uv, mask, obs_feat) with its scene
    as the port's ``Scene`` on the CPU."""
    from sfmx_torch.mapstore.scene import SCENE_FIELDS, Scene

    scene = Scene(**{k: torch.from_numpy(np.array(getattr(st[0], k))) for k in SCENE_FIELDS})
    return (scene,) + tuple(np.array(x) for x in st[1:])


def test_register_landmarks_rejects_overlap_free_pair(disjoint_sessions):
    from sfmx.recon.merge import landmark_descriptors as jld
    from sfmx_torch.recon.merge import landmark_descriptors

    s1, s2 = (to_port_session(s) for s in disjoint_sessions)
    d1 = landmark_descriptors(s1[0], s1[1], s1[4])
    d2 = landmark_descriptors(s2[0], s2[1], s2[4])
    np.testing.assert_array_equal(d1, jld(disjoint_sessions[0][0], disjoint_sessions[0][1],
                                          disjoint_sessions[0][4]))
    with pytest.raises(treg.RegistrationError):
        treg.register_landmarks_verified(
            s1[0].X.numpy(), d1, s1[0].X_alive.numpy(),
            s2[0].X.numpy(), d2, s2[0].X_alive.numpy(), device="cpu",
            noise=jax_draws(jax.random.PRNGKey(0)))


def test_merge_scenes_disjoint_raises(disjoint_sessions):
    """merge_scenes must raise (graph disconnected), never silently ship a
    map stitched from unverifiable registrations."""
    from sfmx_torch.recon.merge import merge_scenes

    with pytest.raises(treg.RegistrationError, match="disconnected|verification"):
        merge_scenes([to_port_session(s) for s in disjoint_sessions])


def test_register_rigid_anchored_thin_region():
    """Rotation-anchored fusion: exact on a thin shared region where
    point-only Umeyama is rotation-degenerate."""
    rng = np.random.default_rng(7)
    s, R, t = _rand_sim3(rng)
    Pb = rng.standard_normal((40, 3)) * 0.1 + np.array([10.0, 0, 0])
    Pa = s * (Pb @ R.T) + t + 0.003 * rng.standard_normal((40, 3))
    Rb_c = np.stack([_rand_rot(rng) for _ in range(6)])
    Ra_c = np.einsum("cij,kj->cik", Rb_c, R)
    reg = treg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    assert abs(reg.s / s - 1.0) < 0.01
    assert np.allclose(reg.R, R, atol=5e-3), np.abs(reg.R - R).max()
    err = np.linalg.norm(reg.s * (Pb @ reg.R.T) + reg.t - Pa, axis=1)
    assert np.median(err) < 0.02
    ref = jreg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    assert reg.s == ref.s and np.array_equal(reg.R, ref.R) and np.array_equal(reg.t, ref.t)
    assert np.array_equal(reg.inliers, ref.inliers) and reg.diag == ref.diag


def test_register_rigid_anchored_outlier_rotation():
    """One corrupted shared camera must be rejected by the rotation mode."""
    rng = np.random.default_rng(8)
    s, R, t = _rand_sim3(rng)
    Pb = rng.standard_normal((30, 3))
    Pa = s * (Pb @ R.T) + t
    Rb_c = np.stack([_rand_rot(rng) for _ in range(5)])
    Ra_c = np.einsum("cij,kj->cik", Rb_c, R)
    Ra_c[0] = _rand_rot(rng)
    reg = treg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    assert reg.diag["rot_inliers"] == 4
    assert np.allclose(reg.R, R, atol=1e-2)
    ref = jreg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    assert reg.diag == ref.diag and np.array_equal(reg.R, ref.R)


def test_register_rigid_anchored_rejects_disagreement():
    rng = np.random.default_rng(9)
    Pa = rng.standard_normal((30, 3))
    Pb = rng.standard_normal((30, 3))
    Ra_c = np.stack([_rand_rot(rng) for _ in range(5)])
    Rb_c = np.stack([_rand_rot(rng) for _ in range(5)])
    with pytest.raises(treg.RegistrationError) as ei:
        treg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    with pytest.raises(jreg.RegistrationError) as ej:
        jreg.register_rigid_anchored(Ra_c, Rb_c, Pa, Pb)
    assert ei.value.attempts == ej.value.attempts


@pytest.mark.parametrize("far_m", [None, 200.0])
def test_a_far_point_loosens_both_registrations(overlapping_sessions, far_m):
    """F15 (a sensitivity both packages share): the verified registration
    scales its inlier threshold and its split-half gate with session A's
    extent, the bounding box of every alive landmark.  With 30 of the 299
    correspondences wrong (session B's descriptors permuted among 30
    landmarks) both verify the same 269 inliers; one more alive landmark of
    A, unobserved and 200 m out (as a low-parallax point a build leaves),
    takes the threshold past the wrong matches, and both packages, with
    the same draws, count all 299 as inliers and reject every attempt at
    the split-half gate."""
    from sfmx.recon.merge import landmark_descriptors

    sc, s1, s2 = overlapping_sessions
    d1 = landmark_descriptors(s1[0], s1[1], s1[4])
    d2 = landmark_descriptors(s2[0], s2[1], s2[4])
    rng = np.random.default_rng(1)
    sub = rng.choice(np.flatnonzero(np.array(s2[0].X_alive)), 30, replace=False)
    d2[sub] = d2[rng.permutation(sub)]
    Xa, alive_a = np.array(s1[0].X), np.array(s1[0].X_alive)
    if far_m is not None:
        far = (Xa[alive_a].mean(0) + np.array([far_m, 0.0, 0.0])).astype(Xa.dtype)
        Xa, alive_a = np.concatenate([Xa, far[None]]), np.concatenate([alive_a, [True]])
        d1 = np.concatenate([d1, np.zeros((1, d1.shape[1]), d1.dtype)])
    args = (Xa, d1, alive_a, np.array(s2[0].X), d2, np.array(s2[0].X_alive))
    sa, sb = port_scene_dict(s1), port_scene_dict(s2)
    port = lambda: treg.register_landmarks_verified(  # noqa: E731
        *args, scene_a=sa, scene_b=sb, device="cpu", noise=jax_draws(jax.random.PRNGKey(3)))
    ref = lambda: jreg.register_landmarks_verified(  # noqa: E731
        *args, scene_a=sa, scene_b=sb, key=jax.random.PRNGKey(3))
    if far_m is None:
        got, want = port(), ref()
        _same_reg(got, want)
        assert got.inliers.sum() == 269
        return
    with pytest.raises(treg.RegistrationError) as got:
        port()
    with pytest.raises(jreg.RegistrationError) as want:
        ref()
    assert [a.get("inliers") for a in got.value.attempts] == \
        [a.get("inliers") for a in want.value.attempts] == [299] * 4
    assert all(a["fail"].startswith("split-half instability")
               for a in got.value.attempts + want.value.attempts)
