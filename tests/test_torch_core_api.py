"""The reference's last public core functions in the port: ``se3``'s
log, quaternion and se(3) maps and ``project_to_so3``; ``cameras``'
``make_intrinsics``, ``bearing`` and ``K_matrix``; ``masking``'s
``masked_argmin``, ``pad_axis_to``, ``first_free_slot``, ``count`` and
``scatter_set``; ``linalg.smallest_eigvec_spd(exact_fallback=True)``; and
``features.scharr`` (zero padding).  The same seeded numpy inputs go through
``sfmx`` (JAX on the CPU) and ``sfmx_torch``; each test states its
tolerance.  The se3 cases mirror ``tests/test_se3.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from sfmx.core import cameras as jcam
from sfmx.core import masking as jmask
from sfmx.core import se3 as jse3
from sfmx.kernels import features as jfeat
from sfmx.solvers import linalg as jlinalg
from sfmx_torch.core import cameras as tcam
from sfmx_torch.core import masking as tmask
from sfmx_torch.core import se3 as tse3
from sfmx_torch.kernels import features as tfeat
from sfmx_torch.solvers import linalg as tlinalg

torch.set_num_threads(2)
CPU = torch.device("cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def _rotvecs(rng, n=64):
    v = rng.normal(size=(n, 3))
    scale = rng.uniform(0.0, np.pi - 1e-3, size=(n, 1))
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * scale).astype(np.float32)


def _rotations(rng, n=64):
    return Rsc.from_rotvec(_rotvecs(rng, n)).as_matrix().astype(np.float32)


# --- se3 ------------------------------------------------------------------


def test_vee_inverts_hat(rng):
    """vee(hat(w)) == w exactly, batched; the reference's vee on each."""
    w = rng.normal(size=(16, 3)).astype(np.float32)
    got = tse3.vee(tse3.hat(T(w))).numpy()
    np.testing.assert_array_equal(got, w)
    ref = np.stack([np.asarray(jse3.vee(jse3.hat(jnp.asarray(x)))) for x in w])
    np.testing.assert_array_equal(got, ref)


def test_so3_log_roundtrip_matches_reference(rng):
    """so3_log of rotations up to pi - 1e-3: the rotation vectors back
    (atol 2e-5, as tests/test_se3.py) and the reference's (atol 1e-5)."""
    w = _rotvecs(rng)
    R = Rsc.from_rotvec(w).as_matrix().astype(np.float32)
    got = tse3.so3_log(T(R)).numpy()
    np.testing.assert_allclose(got, w, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jse3.so3_log_b(jnp.asarray(R))), atol=1e-5)


@pytest.mark.parametrize("angle", [np.pi - 1e-4, 1e-9, 0.0])
def test_so3_log_near_pi_and_identity(angle):
    """Near pi (atol 1e-3, as tests/test_se3.py) and at and near the
    identity, finite and equal to the reference's (atol 1e-6)."""
    w = np.array([0.0, 1.0, 0.0]) * angle
    R = Rsc.from_rotvec(w).as_matrix().astype(np.float32)
    got = tse3.so3_log(T(R)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, w, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jse3.so3_log(jnp.asarray(R))), atol=1e-6)


def test_quaternion_roundtrip_matches_reference(rng):
    """rot_to_quat with w >= 0, unit norm, equal to the reference's (atol
    1e-6); quat_to_rot back to the rotations (atol 1e-5) and equal to the
    reference's on the same quaternions (atol 1e-6)."""
    R = _rotations(rng)
    q = tse3.rot_to_quat(T(R))
    qn = q.numpy()
    assert np.all(qn[:, 0] >= 0.0)
    np.testing.assert_allclose(np.linalg.norm(qn, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(qn, np.asarray(jse3.rot_to_quat_b(jnp.asarray(R))), atol=1e-6)
    R2 = tse3.quat_to_rot(q).numpy()
    np.testing.assert_allclose(R2, R, atol=1e-5)
    np.testing.assert_allclose(R2, np.asarray(jse3.quat_to_rot_b(jnp.asarray(qn))), atol=1e-6)


def test_se3_exp_log_roundtrip_matches_reference(rng):
    """se3_exp then se3_log gives xi back (atol 5e-4, as tests/test_se3.py);
    each map equals the reference's on the same input (atol 2e-5)."""
    xi = rng.normal(scale=0.8, size=(32, 6)).astype(np.float32)
    R, t = tse3.se3_exp(T(xi))
    jR, jt = jax.vmap(jse3.se3_exp)(jnp.asarray(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-5)
    back = tse3.se3_log(R, t).numpy()
    np.testing.assert_allclose(back, xi, atol=5e-4)
    np.testing.assert_allclose(back, np.asarray(jax.vmap(jse3.se3_log)(jR, jt)), atol=2e-5)


def test_project_to_so3_matches_reference(rng):
    """Orthonormal with det +1 (atol 1e-5) and the reference's (atol 1e-5),
    on near-rotations and on a reflection."""
    M = (np.eye(3) + 0.1 * rng.normal(size=(8, 3, 3))).astype(np.float32)
    M[0] = np.diag([1.0, 1.0, -1.0]) + 0.05 * rng.normal(size=(3, 3))
    R = tse3.project_to_so3(T(M)).numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    ref = np.stack([np.asarray(jse3.project_to_so3(jnp.asarray(m))) for m in M])
    np.testing.assert_allclose(R, ref, atol=1e-5)


# --- cameras --------------------------------------------------------------


def test_make_intrinsics_and_K_matrix_match_reference():
    """The record on the device asked for, f32, equal to the reference's;
    its K matrix (and a batch of two) exactly the reference's."""
    args = (500.0, 510.0, 320.0, 240.0, -0.1, 0.02, 0.001)
    k = tcam.make_intrinsics(*args, device=CPU)
    assert k.dtype == torch.float32 and k.device == CPU
    jk = jcam.make_intrinsics(*args)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tcam.make_intrinsics(1.0, 2.0, 3.0, 4.0, device=CPU).numpy(),
                                  np.asarray(jcam.make_intrinsics(1.0, 2.0, 3.0, 4.0)))
    np.testing.assert_array_equal(tcam.K_matrix(k).numpy(), np.asarray(jcam.K_matrix(jk)))
    kb = torch.stack([k, 2 * k])
    Kb = tcam.K_matrix(kb).numpy()
    np.testing.assert_array_equal(Kb[1], np.asarray(jcam.K_matrix(2 * jk)))


def test_make_intrinsics_needs_a_device():
    with pytest.raises(TypeError):
        tcam.make_intrinsics(500.0, 500.0, 320.0, 240.0)


@pytest.mark.parametrize("k1", [0.0, -0.12])
def test_bearing_matches_reference(rng, k1):
    """Unit norm (1e-6) and the reference's bearings (atol 1e-6), with and
    without radial distortion."""
    k = np.array([500.0, 500.0, 320.0, 240.0, k1, 0.01, 0.0], np.float32)
    uv = rng.uniform([0, 0], [640, 480], size=(100, 2)).astype(np.float32)
    b = tcam.bearing(T(k), T(uv)).numpy()
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(b, np.asarray(jcam.bearing(jnp.asarray(k), jnp.asarray(uv))),
                               atol=1e-6)


# --- masking --------------------------------------------------------------


def test_masked_argmin_matches_reference(rng):
    """Values, indices and validity exactly, with a full and an empty row."""
    s = rng.normal(size=(4, 20)).astype(np.float32)
    m = rng.random((4, 20)) > 0.4
    m[2] = False
    m[3] = True
    got = tmask.masked_argmin(T(s), T(m))
    ref = jmask.masked_argmin(jnp.asarray(s), jnp.asarray(m))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got0 = tmask.masked_argmin(T(s), T(m), dim=0)
    ref0 = jmask.masked_argmin(jnp.asarray(s), jnp.asarray(m), axis=0)
    for g, r in zip(got0, ref0):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("size", [3, 5, 9])
@pytest.mark.parametrize("axis", [0, 1])
def test_pad_axis_to_matches_reference(rng, size, axis):
    """Truncated, unchanged and padded with a fill, exactly."""
    x = rng.normal(size=(5, 5)).astype(np.float32)
    got = tmask.pad_axis_to(T(x), size, dim=axis, fill=-7)
    ref = jmask.pad_axis_to(jnp.asarray(x), size, axis=axis, fill=-7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["some", "full", "empty"])
def test_first_free_slot_and_count_match_reference(rng, case):
    """Exactly the reference's, for a partly alive, a full and an empty mask
    (the full mask gives 0 in both: the reference's argmin)."""
    alive = {"some": rng.random(12) > 0.3, "full": np.ones(12, bool),
             "empty": np.zeros(12, bool)}[case]
    assert int(tmask.first_free_slot(T(alive))) == int(jmask.first_free_slot(jnp.asarray(alive)))
    c = tmask.count(T(alive))
    assert c.dtype == torch.int32
    assert int(c) == int(jmask.count(jnp.asarray(alive)))


@pytest.mark.parametrize("pred", [True, False])
def test_scatter_set_matches_reference(rng, pred):
    """A gated set with a tensor index and a device bool, exactly; the input
    is left as it was."""
    arr = rng.normal(size=(10, 3)).astype(np.float32)
    idx = np.array([1, 4, 7])
    val = rng.normal(size=(3, 3)).astype(np.float32)
    a = T(arr)
    got = tmask.scatter_set(a, T(idx), T(val), torch.tensor(pred))
    ref = jmask.scatter_set(jnp.asarray(arr), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(pred))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(a.numpy(), arr)
    # a scalar index and a scalar value with the default pred
    got1 = tmask.scatter_set(a, 2, 5.0)
    ref1 = jmask.scatter_set(jnp.asarray(arr), 2, 5.0)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(ref1))


# --- linalg ---------------------------------------------------------------


def _broken_batch(rng):
    """12x12 symmetric matrices: six SPD ones, and six singular ones whose
    smallest eigenvalue sits below zero, past the 1e-8 shift, so that
    Cholesky breaks down on them (a clear eigen-gap above it)."""
    out = []
    for i in range(12):
        Q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
        lam = rng.uniform(1.0, 100.0, 12)
        lam[0] = -1e-3 if i % 2 else 0.05
        out.append((Q * lam) @ Q.T)
    return np.stack(out).astype(np.float32)


def test_exact_fallback_takes_eigh_on_broken_matrices_only(rng):
    """exact_fallback=True: the broken matrices get the reference's eigh
    vector (up to sign, atol 1e-4), the others are bit-equal to
    exact_fallback=False, whose result the default keeps."""
    A = _broken_batch(rng)
    plain = tlinalg.smallest_eigvec_spd(T(A)).numpy()
    np.testing.assert_array_equal(plain, tlinalg.smallest_eigvec_spd(T(A),
                                                                      exact_fallback=False).numpy())
    exact = tlinalg.smallest_eigvec_spd(T(A), exact_fallback=True).numpy()
    ref = np.asarray(jax.vmap(jlinalg.smallest_eigvec_spd)(jnp.asarray(A)))
    broken = np.all(plain == np.float32(1.0 / np.sqrt(12.0)), axis=1)
    assert broken[1::2].all() and not broken[0::2].any()
    np.testing.assert_array_equal(exact[~broken], plain[~broken])
    sign = np.sign(np.sum(exact * ref, axis=1, keepdims=True))
    np.testing.assert_allclose(exact * sign, ref, atol=1e-4)
    # unbatched, and a NaN matrix: NaN, as the reference's eigh gives
    one = tlinalg.smallest_eigvec_spd(T(A[1]), exact_fallback=True).numpy()
    np.testing.assert_array_equal(one, exact[1])
    nan = np.full((1, 12, 12), np.nan, np.float32)
    got = tlinalg.smallest_eigvec_spd(T(np.concatenate([A[:2], nan])), exact_fallback=True)
    assert torch.isnan(got[2]).all()
    assert np.isnan(np.asarray(jlinalg.smallest_eigvec_spd(jnp.asarray(nan[0])))).all()


# --- features -------------------------------------------------------------


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_scharr_zero_padded_matches_reference(rng, dilation):
    """Zero-padded Scharr derivatives at each dilation (atol 1e-6); the
    periodic ``scharr_roll`` differs only within ``dilation`` of the edge."""
    x = rng.random((2, 24, 32)).astype(np.float32)
    gx, gy = tfeat.scharr(T(x), dilation)
    rx, ry = jfeat.scharr(jnp.asarray(x), dilation)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-6)
    px, py = tfeat.scharr_roll(T(x), dilation)
    d = dilation
    inner = (slice(None), slice(d, -d), slice(d, -d))
    np.testing.assert_allclose(gx.numpy()[inner], px.numpy()[inner], atol=1e-6)
    np.testing.assert_allclose(gy.numpy()[inner], py.numpy()[inner], atol=1e-6)
