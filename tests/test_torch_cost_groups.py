"""K8's order of sums on the CPU: ``segsum.ba_cost_fused_grouped`` (slot
groups, a point's group partials in group order, a shuffle tree over each
block of 32 points, the blocks in a fixed strided order: the order of
``sfmx_torch/csrc/ba.cu``'s K8 launch, whose last block adds the blocks'
partials) against the port's plain
version and against ``sfmx.kernels.segsum.ba_cost_fused`` (interpret mode)
and ``sfmx.solvers.lm._eval_cost``, on the same numpy inputs.

Tolerances: rel 1e-6 against the plain version (the same terms, summed in
another order, ~2,000 positive terms); rtol 1e-4 against ``_eval_cost`` (the
reference's own tolerance between its kernel and ``_eval_cost``) and 5e-4
against the interpreted kernel, whose one-hot gather carries the camera
table as a hi/lo bf16 pair (16 mantissa bits), as in ``test_torch_segsum.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import segsum as jseg
from sfmx.solvers import lm as jlm
from sfmx_torch.kernels import segsum as tseg
from tests.test_segsum import _raw_local_scene

torch.set_num_threads(2)
SHIFTS = [(0.0, 0.0), (0.01, 0.005), (-0.02, 0.0), (0.0, 0.01)]


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, _ = _raw_local_scene(C=100, P=512, O=2000)
    w = w.at[::7].set(0.0)                       # dead observations ride along
    C, P = R.shape[0], X.shape[0]
    tp = 16
    dense = jseg.build_dense_obs(pt_id, cam_id, P, C, tp)
    uvw = jseg.pack_rows(dense, jnp.concatenate([uv, w[:, None]], 1))
    d = tseg.build_dense_obs(T(pt_id), T(cam_id), P, C, tp)
    tuvw = tseg.pack_rows(d, torch.cat([T(uv), T(w)[:, None]], 1))
    tcam = torch.cat([tseg.build_cam_table(T(intr), T(k_idx), T(R), T(t) + a) for a, _ in SHIFTS])
    tx = torch.cat([(T(X) + b).T for _, b in SHIFTS], 0).contiguous()
    return (intr, k_idx, R, t, X, cam_id, pt_id, uv, w), dense, uvw, d, tuvw, tcam, tx


@pytest.mark.parametrize("groups", [1, 3, 8, 16, None])
def test_grouped_matches_plain(case, groups):
    """Slot-group counts the kernel takes, and its own choice for the layout
    (None): rel 1e-6 of the plain version for all four candidates."""
    _, _, _, d, tuvw, tcam, tx = case
    delta = 1.0 / 500.0
    got = tseg.ba_cost_fused_grouped(tcam, d, tuvw, tx, delta, 4, groups=groups)
    ref = tseg.ba_cost_fused_plain(tcam, d.camp, tuvw, tx, delta, 4)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=0)


def test_slot_groups_follow_the_layout():
    """The kernel's groups double until the grid holds COST_FILL_THREADS
    threads, up to 16 and not past tp: 16 at the build's 2,290 points, 4 at
    20,000, tp itself for short layouts."""
    assert tseg.cost_slot_groups(64, 2290) == 16
    assert tseg.cost_slot_groups(32, 20000) == 4
    assert tseg.cost_slot_groups(8, 131) == 8 and tseg.cost_slot_groups(3, 131) == 4
    assert tseg.cost_slot_groups(32, 10 ** 7) == 1


@pytest.mark.parametrize("nc", [1, 4])
def test_grouped_matches_reference(case, nc):
    """Against ``ba_cost_fused(interpret=True)`` (rtol 5e-4) and the
    reference's ``_eval_cost`` of each candidate (rtol 1e-4)."""
    (intr, k_idx, R, t, X, cam_id, pt_id, uv, w), dense, uvw, d, tuvw, tcam, tx = case
    C, P = R.shape[0], X.shape[0]
    delta = 4.0 / 500.0
    pp = dense.camp.shape[1]
    cam19s = jnp.concatenate([jseg.build_cam_table(intr, k_idx, R, t + a)
                              for a, _ in SHIFTS[:nc]], 0)
    x8s = jnp.zeros((8 * nc, pp), jnp.float32)
    for c, (_, b) in enumerate(SHIFTS[:nc]):
        x8s = x8s.at[8 * c:8 * c + 3, :P].set(X.T + b)
    ref = np.asarray(jseg.ba_cost_fused(cam19s, dense.camp, uvw, x8s, delta, tp=16, nc=nc,
                                        interpret=True))
    got = tseg.ba_cost_fused_grouped(tcam[:19 * nc], d, tuvw, tx[:3 * nc], delta, nc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4)
    for c, (a, b) in enumerate(SHIFTS[:nc]):
        cj = jlm._eval_cost(intr, k_idx, R, t + a, X + b, cam_id, pt_id, uv, w, delta)
        np.testing.assert_allclose(float(got[c]), float(cj), rtol=1e-4)


@pytest.mark.parametrize("groups", [1, None])
def test_candidate_cost_is_the_same_bits_alone_or_among_four(case, groups):
    """A candidate's cost from an nc = 1 pass equals, bit for bit, its cost
    at any place among four (the LM loop compares the two)."""
    _, _, _, d, tuvw, tcam, tx = case
    delta = 1.0 / 500.0
    four = tseg.ba_cost_fused_grouped(tcam, d, tuvw, tx, delta, 4, groups=groups)
    perm = [2, 0, 3, 1]
    shuffled = tseg.ba_cost_fused_grouped(
        tcam.reshape(4, 19, -1)[perm].reshape(76, -1), d, tuvw,
        tx.reshape(4, 3, -1)[perm].reshape(12, -1), delta, 4, groups=groups)
    assert torch.equal(shuffled, four[perm])
    for c in range(4):
        one = tseg.ba_cost_fused_grouped(tcam[19 * c:19 * c + 19], d, tuvw, tx[3 * c:3 * c + 3],
                                         delta, 1, groups=groups)
        assert torch.equal(one, four[c:c + 1])
