"""K6-K8 on the CPU: the port's dense layout and the plain versions of its
fused BA kernels against ``sfmx.kernels.segsum`` on the same numpy inputs.

The reference's Pallas kernels run as its own tests run them on the CPU
(``interpret=True``) and through ``schur_cross_matvec_ref``.  The port keeps
the reference's row conventions without its padding, so the reference's
outputs are sliced to the first 6/3/9 rows and the first C/P columns.

Tolerances, and why:
- layout (``build_dense_obs``, ``pack_rows``): integer tables equal slot for
  slot, packed values equal exactly (a gather);
- K6: z and vy within rtol 1e-4 plus 1e-4 of the largest entry (the
  reference's own kernel tolerance, ``assert_allclose(rtol=1e-4,
  atol=1e-4*scale)``: f32 sums of up to tp*6 products in another order);
- K6's kernel decomposition (``schur_cross_matvec_two_pass``: slot groups,
  the camera-major scratch through ``slot_pos``, a run sum per camera):
  the same tolerance against the plain version and the reference, since
  only the order of the sums differs; ``slot_pos`` itself is exact;
- K7 against the reference's planes pipeline (exact f32 gathers): U, V9, W
  within 1e-4 relative to the largest entry, b_c within 2e-3 and b_p within
  1e-3 (near-cancelling sums), cost rtol 1e-4: the reference's own
  tolerances between its kernel and that pipeline.  Against the interpreted
  Pallas kernel the same but 5e-4 for U, V9, W and the cost: its one-hot
  gather carries the camera table as a hi/lo bf16 pair, 16 mantissa bits,
  and a Huber weight delta/|r| repeats the residual's relative error;
- K8: rtol 1e-4 against ``_eval_cost`` (the reference's tolerance between
  its kernel and ``_eval_cost``), 5e-4 against the interpreted kernel (the
  same 16-bit gather).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import segsum as jseg
from sfmx.solvers import lm as jlm
from sfmx.solvers import schur as jschur
from sfmx_torch.kernels import segsum as tseg
from sfmx_torch.solvers import lm as tlm
from sfmx_torch.solvers import schur as tschur
from tests.test_segsum import _planes_system, _raw_local_scene

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-20))


@pytest.mark.parametrize("tp_cap", [32, 3])
def test_dense_layout_matches_reference(tp_cap):
    """camp and rows equal the reference's slot for slot (tp_cap=3 drops
    overflow on both sides); cnt and the camera-major list are consistent."""
    sysp, dense, (cam_id, pt_id), nbp = _planes_system(tp_cap=tp_cap)
    C, P, O = 24, 600, len(cam_id)
    d = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, tp_cap)
    np.testing.assert_array_equal(d.camp.numpy(), np.asarray(dense.camp)[:, :P])
    np.testing.assert_array_equal(d.rows.numpy(), np.asarray(dense.rows)[:, :P])
    lens = np.bincount(np.asarray(pt_id), minlength=P)
    np.testing.assert_array_equal(d.cnt.numpy(), np.minimum(lens, tp_cap))
    # the camera-major list names every dense slot once, grouped by camera
    slots = d.cam_slot.numpy()
    assert len(slots) == int(d.cnt.sum()) and len(np.unique(slots)) == len(slots)
    cams = d.camp.numpy().reshape(-1)[slots]
    assert (np.diff(cams) >= 0).all()
    np.testing.assert_array_equal(d.cam_ptr.numpy(), np.searchsorted(cams, np.arange(C + 1)))
    assert (d.rows.numpy().reshape(-1)[slots] < O).all()
    # pack_rows
    W = np.asarray(nbp.W18)
    np.testing.assert_array_equal(tseg.pack_rows(d, T(W)).numpy(),
                                  np.asarray(jseg.pack_rows(dense, nbp.W18))[:, :P])


def test_dense_layout_pad_fill_is_a_real_camera():
    """A point without observations gets the camera of the nearest following
    observation in every slot (never an out-of-range id)."""
    pt = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32)
    cam = torch.tensor([3, 1, 2, 0, 3], dtype=torch.int32)
    d = tseg.build_dense_obs(pt, cam, 4, 4, 2)
    assert d.camp.tolist() == [[3, 2, 2, 3], [1, 2, 0, 3]]
    assert d.cnt.tolist() == [2, 0, 2, 0]
    assert d.rows.tolist() == [[0, 5, 2, 5], [1, 5, 3, 5]]


def _k6_inputs(tp_cap):
    sysp, dense, _, nbp = _planes_system(tp_cap=tp_cap)
    C, P = 24, 600
    pp = dense.camp.shape[1]
    cp = 128
    rng = np.random.default_rng(1)
    x = rng.standard_normal((C, 6)).astype(np.float32)
    # a bias of b_p's size: a unit-size one drives vy to ~1e8 and z into
    # cancellations where f32 itself holds only 6e-5 of the largest entry
    bias = (np.asarray(nbp.b_p) * rng.uniform(-1.5, 1.5, (P, 3))).astype(np.float32)
    Wp = jseg.pack_rows(dense, sysp.blocks.W18)
    vinv16 = jnp.zeros((16, pp), jnp.float32).at[:9, :P].set(sysp.Vinv9.T)
    x8 = jnp.zeros((8, cp), jnp.float32).at[:6, :C].set(x.T)
    bp8 = jnp.zeros((8, pp), jnp.float32).at[:3, :P].set(nbp.b_p.T)
    rb8 = jnp.zeros((8, pp), jnp.float32).at[:3, :P].set(bias.T)
    return sysp, dense, nbp, Wp, vinv16, x8, bp8, rb8


@pytest.mark.parametrize("tp_cap", [32, 3], ids=["fits", "overflow-dropped"])
@pytest.mark.parametrize("use", ["matvec", "rhs", "backsub", "bias"])
def test_k6_plain_matches_reference(use, tp_cap):
    """The three uses of the kernel (CG matvec: no bias; Schur rhs: x = 0,
    bias = b_p; back-substitution: bias = -b_p) and a random bias, against
    the jnp oracle and the interpreted Pallas kernel."""
    sysp, dense, nbp, Wp, vinv16, x8, bp8, rb8 = _k6_inputs(tp_cap)
    C, P = 24, 600
    tp = dense.camp.shape[0]
    xj, bj = {"matvec": (x8, None), "rhs": (jnp.zeros_like(x8), bp8),
              "backsub": (x8, -bp8), "bias": (x8, rb8)}[use]
    z_ref, vy_ref = jseg.schur_cross_matvec_ref(Wp, dense.camp, vinv16, xj, bj)
    z_ker, vy_ker = jseg.schur_cross_matvec(Wp, dense.camp, vinv16, xj, bj, tp=tp,
                                            interpret=True)
    d = tseg.build_dense_obs(T(np.asarray(nbp.pt_id)), T(np.asarray(nbp.cam_id)), P, C, tp_cap)
    z, vy = tseg.schur_cross_matvec(
        T(Wp)[:, :P].contiguous(), d, T(vinv16)[:9, :P].contiguous(),
        T(xj)[:6, :C].contiguous(), None if bj is None else T(bj)[:3, :P].contiguous())
    assert z.shape == (6, C) and vy.shape == (3, P)
    for ref_z, ref_vy in ((z_ref, vy_ref), (z_ker, vy_ker)):
        rz, rvy = np.asarray(ref_z)[:6, :C], np.asarray(ref_vy)[:3, :P]
        np.testing.assert_allclose(z.numpy(), rz, rtol=1e-4, atol=1e-4 * np.abs(rz).max())
        np.testing.assert_allclose(vy.numpy(), rvy, rtol=1e-4, atol=1e-4 * np.abs(rvy).max())


@pytest.mark.parametrize("tp_cap", [32, 3, 1])
def test_slot_pos_places_every_dense_slot_once_in_camera_order(tp_cap):
    """``slot_pos`` is the inverse of the camera-sorted slot list: every
    dense slot has one place, pads have none, a camera's places are one run
    (``cam_ptr``), and inside a run the slots keep their (slot, point) order
    (the stable sort that makes a camera's sum reproducible)."""
    _, _, (cam_id, pt_id), _ = _planes_system(tp_cap=tp_cap)
    C, P = 24, 600
    d = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, tp_cap)
    pos, cnt, camp = d.slot_pos.numpy(), d.cnt.numpy(), d.camp.numpy()
    assert pos.shape == (tp_cap, P) and pos.dtype == np.int32
    real = np.arange(tp_cap)[:, None] < cnt[None, :]
    n_dense = int(cnt.sum())
    assert (pos[~real] == -1).all()
    np.testing.assert_array_equal(np.sort(pos[real]), np.arange(n_dense))
    np.testing.assert_array_equal(d.cam_slot.numpy()[pos[real]], np.flatnonzero(real.reshape(-1)))
    by_place = np.empty(n_dense, np.int64)
    by_place[pos[real]] = camp[real]
    assert (np.diff(by_place) >= 0).all()
    np.testing.assert_array_equal(d.cam_ptr.numpy(), np.searchsorted(by_place, np.arange(C + 1)))
    flat = d.cam_slot.numpy().astype(np.int64)
    same_cam = np.diff(by_place) == 0
    assert (np.diff(flat)[same_cam] > 0).all()


@pytest.mark.parametrize("groups", [1, 5, tseg.SLOT_GROUPS, 32])
@pytest.mark.parametrize("tp_cap", [32, 3], ids=["fits", "overflow-dropped"])
@pytest.mark.parametrize("use", ["matvec", "bias"])
def test_k6_two_pass_matches_plain_and_reference(use, tp_cap, groups):
    """The kernel's decomposition in plain PyTorch (slots split over
    ``groups`` threads, W vy scattered to camera-major places, a run sum per
    camera) against ``schur_cross_matvec_plain`` and the jnp oracle."""
    sysp, dense, nbp, Wp, vinv16, x8, bp8, rb8 = _k6_inputs(tp_cap)
    C, P = 24, 600
    xj, bj = {"matvec": (x8, None), "bias": (x8, rb8)}[use]
    d = tseg.build_dense_obs(T(np.asarray(nbp.pt_id)), T(np.asarray(nbp.cam_id)), P, C, tp_cap)
    args = (T(Wp)[:, :P].contiguous(), d, T(vinv16)[:9, :P].contiguous(),
            T(xj)[:6, :C].contiguous(), None if bj is None else T(bj)[:3, :P].contiguous())
    z, vy = tseg.schur_cross_matvec_two_pass(*args, groups=groups)
    pz, pvy = tseg.schur_cross_matvec_plain(args[0], d.camp, *args[2:])
    jz, jvy = jseg.schur_cross_matvec_ref(Wp, dense.camp, vinv16, xj, bj)
    for rz, rvy in ((pz.numpy(), pvy.numpy()), (np.asarray(jz)[:6, :C], np.asarray(jvy)[:3, :P])):
        np.testing.assert_allclose(z.numpy(), rz, rtol=1e-4, atol=1e-4 * np.abs(rz).max())
        np.testing.assert_allclose(vy.numpy(), rvy, rtol=1e-4, atol=1e-4 * np.abs(rvy).max())


def test_bound_matvec_equals_the_wrapper_and_checks_its_vectors():
    """``SchurMatvec`` (the system checked once) returns what the one-shot
    wrapper returns; a CPU system refuses vectors that are not on the CPU."""
    sysp, dense, nbp, Wp, vinv16, x8, bp8, rb8 = _k6_inputs(32)
    C, P = 24, 600
    d = tseg.build_dense_obs(T(np.asarray(nbp.pt_id)), T(np.asarray(nbp.cam_id)), P, C, 32)
    W, vinv = T(Wp)[:, :P].contiguous(), T(vinv16)[:9, :P].contiguous()
    x, b = T(x8)[:6, :C].contiguous(), T(rb8)[:3, :P].contiguous()
    bound = tseg.SchurMatvec(W, d, vinv)
    for got, ref in zip(bound(x, b), tseg.schur_cross_matvec(W, d, vinv, x, b)):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        bound(torch.empty((6, C), device="meta"))


def test_overflow_chain_equals_the_unsplit_system():
    """``schur._cross`` with the observations past slot 3 riding the planes
    ops (their W^T x through the kernel's bias, their W vy added to its
    output) equals K6 on the layout that holds every observation: rtol 1e-4
    plus 1e-4 of the largest entry."""
    sysp, _, (cam_id, pt_id), nbp = _planes_system(tp_cap=32)
    C, P, tp = 24, 600, 3
    W18, vinv = T(np.asarray(nbp.W18)), T(np.asarray(sysp.Vinv9)).T.contiguous()
    full = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, 32)
    cut = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, tp)
    start = np.searchsorted(np.asarray(pt_id), np.arange(P))
    ov = T(np.flatnonzero(np.arange(len(pt_id)) - start[np.asarray(pt_id)] >= tp))
    assert len(ov) > 100
    sysd = tschur.SchurSystemD(tseg.SchurMatvec(tseg.pack_rows(cut, W18), cut, vinv),
                               T(np.asarray(nbp.b_p)).T.contiguous(), None, None,
                               W18[ov], tschur.segment_plan(T(cam_id)[ov], C),
                               tschur.segment_plan(T(pt_id)[ov], P))
    rng = np.random.default_rng(2)
    x6 = T(rng.standard_normal((6, C)).astype(np.float32))
    for bias in (None, sysd.bp3):
        z, vy = tschur._cross(sysd, x6, bias)
        rz, rvy = tseg.schur_cross_matvec(tseg.pack_rows(full, W18), full, vinv, x6, bias)
        np.testing.assert_allclose(z.numpy(), rz.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(rz.abs().max()))
        np.testing.assert_allclose(vy.numpy(), rvy.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(rvy.abs().max()))


def _k7_inputs(tp_cap=16):
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, _ = _raw_local_scene(C=100, P=512, O=2000)
    w = w.at[::7].set(0.0)                       # dead observations ride along
    C, P = R.shape[0], X.shape[0]
    dense = jseg.build_dense_obs(pt_id, cam_id, P, C, tp_cap)
    uvw = jseg.pack_rows(dense, jnp.concatenate([uv, w[:, None]], 1))
    d = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, tp_cap)
    tuvw = tseg.pack_rows(d, torch.cat([T(uv), T(w)[:, None]], 1))
    np.testing.assert_array_equal(tuvw.numpy(), np.asarray(uvw)[:, :P])
    return (intr, k_idx, R, t, X, cam_id, pt_id, uv, w), dense, uvw, d, tuvw


def test_k7_plain_matches_reference():
    """Plain K7 against ``ba_assemble_fused(interpret=True)`` decoded, on a
    100-camera local scene with radial distortion, a Huber threshold that
    bites and some zero-weight observations."""
    (intr, k_idx, R, t, X, cam_id, pt_id, uv, w), dense, uvw, d, tuvw = _k7_inputs()
    C, P = R.shape[0], X.shape[0]
    delta = 0.6 / 500.0
    cam19 = jseg.build_cam_table(intr, k_idx, R, t)
    pp = dense.camp.shape[1]
    x8 = jnp.zeros((8, pp), jnp.float32).at[:3, :P].set(X.T)
    u96, v16, Wp = jseg.ba_assemble_fused(cam19, dense.camp, uvw, x8, delta, tp=16,
                                          interpret=True)
    ub = np.asarray(u96[:48] + u96[48:])
    tcam19 = tseg.build_cam_table(T(intr), T(k_idx), T(R), T(t))
    np.testing.assert_array_equal(tcam19.numpy(), np.asarray(cam19)[:, :C])
    U, b_c, v13, tWp = tseg.ba_assemble_fused(tcam19, d, tuvw, T(X).T.contiguous(), delta)
    r, Jc, Jp = jlm._jacobians_planes(intr, k_idx, R, t, X, cam_id, pt_id, uv)
    r2 = jnp.sum(r * r, -1)
    nbp = jschur.assemble_planes(Jc, Jp, r, w * jlm.huber_weight(r2, delta), cam_id, pt_id,
                                 C, P, pt_sorted=True)
    refs = {"planes": (nbp.U, nbp.b_c, nbp.V9.T, nbp.b_p.T, jseg.pack_rows(dense, nbp.W18),
                       float(jlm.robust_cost(r2, w, delta)), 1e-4),
            "kernel": (ub[:36, :C].T.reshape(C, 6, 6), ub[36:42, :C].T, v16[:9], v16[9:12], Wp,
                       float(jnp.sum(v16[12])), 5e-4)}
    for name, (rU, rbc, rV9, rbp, rW, rcost, tol) in refs.items():
        assert rel(U.numpy(), rU) < tol, name
        assert rel(b_c.numpy(), rbc) < 2e-3, name
        assert rel(v13[:9].numpy(), np.asarray(rV9)[:, :P]) < tol, name
        assert rel(v13[9:12].numpy(), np.asarray(rbp)[:, :P]) < 1e-3, name
        assert rel(tWp.numpy(), np.asarray(rW)[:, :P]) < tol, name
        np.testing.assert_allclose(float(v13[12].sum()), rcost, rtol=tol, err_msg=name)
    # the Huber branch is really exercised
    frac = float(jnp.mean(jnp.sqrt(r2) > delta))
    assert 0.05 < frac < 0.95


@pytest.mark.parametrize("nc", [1, 4])
def test_k8_plain_matches_reference(nc):
    """Plain K8 against ``ba_cost_fused(interpret=True)`` and ``_eval_cost``
    (both sides) for nc stacked candidates."""
    (intr, k_idx, R, t, X, cam_id, pt_id, uv, w), dense, uvw, d, tuvw = _k7_inputs()
    C, P = R.shape[0], X.shape[0]
    delta = 4.0 / 500.0
    pp = dense.camp.shape[1]
    shifts = [(0.0, 0.0), (0.01, 0.005), (-0.02, 0.0), (0.0, 0.01)][:nc]
    cam19s = jnp.concatenate([jseg.build_cam_table(intr, k_idx, R, t + a) for a, _ in shifts], 0)
    x8s = jnp.zeros((8 * nc, pp), jnp.float32)
    for c, (_, b) in enumerate(shifts):
        x8s = x8s.at[8 * c:8 * c + 3, :P].set(X.T + b)
    ref = np.asarray(jseg.ba_cost_fused(cam19s, dense.camp, uvw, x8s, delta, tp=16, nc=nc,
                                        interpret=True))
    tcam = torch.cat([tseg.build_cam_table(T(intr), T(k_idx), T(R), T(t) + a)
                      for a, _ in shifts], 0)
    tx = torch.cat([(T(X) + b).T for _, b in shifts], 0).contiguous()
    got = tseg.ba_cost_fused(tcam, d, tuvw, tx, delta, nc=nc)
    assert got.shape == (nc,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4)
    for c, (a, b) in enumerate(shifts):
        cj = jlm._eval_cost(intr, k_idx, R, t + a, X + b, cam_id, pt_id, uv, w, delta)
        ct = tlm._eval_cost(T(intr), T(k_idx), T(R), T(t) + a, T(X) + b, T(cam_id), T(pt_id),
                            T(uv), T(w), delta)
        np.testing.assert_allclose(float(got[c]), float(cj), rtol=1e-4)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


def test_k7_and_k8_agree_on_the_cost():
    """cost0 (K8, nc=1) and the assembly's cost (K7) come from one model:
    equal to f32 rounding, so an LM step is never judged across two codes."""
    (intr, k_idx, R, t, X, *_), dense, uvw, d, tuvw = _k7_inputs()
    delta = 1.0 / 500.0
    cam19 = tseg.build_cam_table(T(intr), T(k_idx), T(R), T(t))
    x3 = T(X).T.contiguous()
    c8 = float(tseg.ba_cost_fused(cam19, d, tuvw, x3, delta, nc=1)[0])
    c7 = float(tseg.ba_assemble_fused(cam19, d, tuvw, x3, delta)[2][12].sum())
    assert abs(c7 - c8) <= 1e-6 * abs(c8)


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    """A wrapper takes its plain version only when every tensor is on the
    CPU; anything else must be a well-formed CUDA call."""
    _, dense, uvw, d, tuvw = _k7_inputs()
    meta = torch.empty((19, 100), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tseg.ba_assemble_fused(meta, d, tuvw, torch.zeros(3, 512), 0.01)
