"""K7's work decomposition on the CPU: ``segsum.ba_assemble_fused_grouped``,
a plain mirror of the CUDA kernel's order of sums (slot groups per point
added in group order; each slot's camera-side terms through ``slot_pos``
into a camera-major scratch; a camera's run summed in 18 row phases added in
order), against the port's plain version and ``sfmx``'s interpreted Pallas
kernel; the slot-group count as a function of the layout alone.

Tolerances: against the plain version 1e-5 of the largest entry (only the
order of f32 sums differs); against the reference's interpreted kernel the
tolerances of ``test_torch_segsum.py``'s K7 test (its one-hot gather carries
the camera table as a hi/lo bf16 pair); the scratch's rows are a gather and
equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import segsum as jseg
from sfmx_torch.kernels import segsum as tseg
from tests.smoke_scenes import ba_problem
from tests.test_torch_segsum import T, _k7_inputs, rel

torch.set_num_threads(2)

# (C, P, O, tp, long tracks): P off the 32-point block, overflow left out,
# tracks of ~30 views at tp = 64, and a tiny problem
SHAPES = [(24, 600, 4000, 32, 0), (37, 1001, 5000, 4, 8), (5, 131, 300, 8, 0),
          (96, 500, 15000, 64, 12)]


def _case(C, P, O, tp, longs, delta=1.0 / 500.0):
    p = {k: torch.as_tensor(v) for k, v in
         ba_problem(C, P, O, seed=C, long_tracks=longs, perturb=0.01).items()}
    d = tseg.build_dense_obs(p["pt_id"], p["cam_id"], P, C, tp)
    uvw = tseg.pack_rows(d, torch.cat([p["uv"], p["w_valid"][:, None]], 1))
    cam19 = tseg.build_cam_table(p["intr"], p["k_idx"], p["R"], p["t"])
    return d, uvw, cam19, p["X"].T.contiguous(), delta


@pytest.mark.parametrize("groups", [None, 1, 3, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_mirror_matches_plain(shape, groups):
    """U, b_c, V9/b_p/cost and W within 1e-5 of the largest entry; a camera
    without observations gets zero blocks, U is symmetric, and pad slots
    carry W = 0."""
    d, uvw, cam19, x3, delta = _case(*shape)
    got = tseg.ba_assemble_fused_grouped(cam19, d, uvw, x3, delta, groups=groups)
    ref = tseg.ba_assemble_fused_plain(cam19, d.camp, uvw, x3, delta)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel(g.numpy(), r.numpy()) <= 1e-5
    U, bc, v13, Wp = got
    assert torch.equal(U, U.transpose(1, 2))
    assert float(U[-1].abs().max()) == 0.0 and float(bc[-1].abs().max()) == 0.0
    tp, P = d.camp.shape
    pad = torch.arange(tp)[:, None] >= d.cnt[None, :]
    assert float(Wp.reshape(tp, 18, P).permute(0, 2, 1)[pad].abs().max()) == 0.0


def test_grouped_mirror_matches_reference_kernel():
    """The mirror against ``sfmx.kernels.segsum.ba_assemble_fused`` in
    interpret mode, decoded as test_torch_segsum's K7 test decodes it."""
    (intr, k_idx, R, t, X, *_), dense, uvw, d, tuvw = _k7_inputs()
    C, P = R.shape[0], X.shape[0]
    delta = 0.6 / 500.0
    cam19 = jseg.build_cam_table(intr, k_idx, R, t)
    x8 = jnp.zeros((8, dense.camp.shape[1]), jnp.float32).at[:3, :P].set(X.T)
    u96, v16, Wp = jseg.ba_assemble_fused(cam19, dense.camp, uvw, x8, delta, tp=16,
                                          interpret=True)
    ub = np.asarray(u96[:48] + u96[48:])
    tcam19 = tseg.build_cam_table(T(intr), T(k_idx), T(R), T(t))
    U, b_c, v13, tWp = tseg.ba_assemble_fused_grouped(tcam19, d, tuvw, T(X).T.contiguous(), delta)
    assert rel(U.numpy(), ub[:36, :C].T.reshape(C, 6, 6)) < 5e-4
    assert rel(b_c.numpy(), ub[36:42, :C].T) < 2e-3
    assert rel(v13[:9].numpy(), np.asarray(v16[:9])[:, :P]) < 5e-4
    assert rel(v13[9:12].numpy(), np.asarray(v16[9:12])[:, :P]) < 1e-3
    assert rel(tWp.numpy(), np.asarray(Wp)[:, :P]) < 5e-4
    np.testing.assert_allclose(float(v13[12].sum()), float(jnp.sum(v16[12])), rtol=5e-4)


@pytest.mark.parametrize("tp,P,expect", [(64, 2290, 16), (32, 20000, 4), (4, 1001, 4),
                                         (8, 131, 8), (64, 70000, 1), (1, 500, 1)])
def test_slot_groups_are_a_function_of_the_layout(tp, P, expect):
    """The group count follows (tp, P) alone: doubled from 1 while the grid
    holds fewer than ASM_FILL_THREADS threads, at most tp and
    ASM_MAX_GROUPS; the same for any cameras and observations on that
    layout, so every assembly of a solve sums in one order."""
    g = tseg.assemble_slot_groups(tp, P)
    assert g == expect
    assert g & (g - 1) == 0 and 1 <= g <= min(tseg.ASM_MAX_GROUPS, max(tp, 1))
    d1, *_ = _case(24, 600, 4000, 32, 0)
    d2, *_ = _case(37, 600, 9000, 32, 0)
    assert d1.camp.shape == d2.camp.shape
    assert tseg.assemble_slot_groups(*d1.camp.shape) == tseg.assemble_slot_groups(*d2.camp.shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_cam_scratch_through_slot_pos_equals_index_add(shape):
    """Every real slot's terms land in its row ``slot_pos`` of the
    camera-major scratch (exactly: a scatter), the scratch holds each
    camera's slots as one run from ``cam_ptr``, and the runs' sums equal
    the plain version's ``index_add_`` over the slots' cameras."""
    d, *_ = _case(*shape)
    tp, P = d.camp.shape
    C = d.cam_ptr.shape[0] - 1
    terms = torch.randn((tseg.ASM_CAM_TERMS, tp, P), generator=torch.Generator().manual_seed(0))
    zc = tseg.assemble_cam_scratch(terms, d)
    real = torch.arange(tp)[:, None] < d.cnt[None, :]
    assert zc.shape == (int(real.sum()), tseg.ASM_CAM_TERMS)
    assert torch.equal(zc[d.slot_pos[real].long()], terms[:, real].T)
    runs = (d.cam_ptr[1:] - d.cam_ptr[:-1]).long()
    cam_of = torch.repeat_interleave(torch.arange(C), runs)
    assert torch.equal(cam_of, d.camp[real][torch.argsort(d.slot_pos[real])].long())
    by_run = torch.zeros((C, tseg.ASM_CAM_TERMS)).index_add_(0, cam_of, zc)
    ref = torch.zeros((C, tseg.ASM_CAM_TERMS)).index_add_(0, d.camp[real].long(), terms[:, real].T)
    assert rel(by_run.numpy(), ref.numpy()) <= 1e-5
