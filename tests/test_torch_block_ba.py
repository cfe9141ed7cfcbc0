"""The port's point-sharded BA (``sfmx_torch.dist.block_ba``) in four gloo
ranks against the reference's on a 4-device sub-mesh of the 8 virtual CPU
devices, on the same inputs: the parity (corridor, orbit), joint-intrinsics
and checkpoint-resume cases of ``tests/test_block_ba.py``.

Tolerances: both solvers run the planes block algebra on the same layout,
but the backends' collectives and the port's fixed-order segment sums add
in another order than the reference's segment_sum and psum, so the final
costs agree within 1e-3 relative (the corridor and orbit end at their 0.3 /
0.4 px noise floors) and the refined focal within 1e-4 relative; the
reference's own gates stand beside (5 % of the single-device solver, 10 %
for the joint cost, 1 % / 2 % for the focal).  The port's checkpointed
solve resumed after its first chunk is bit-identical to the uninterrupted
chunked one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sfmx.core import se3
from sfmx.dist import block_ba, mesh as meshlib
from sfmx.solvers import lm
from sfmx_torch.dist import mesh as tmesh
from tests import torch_dist_ranks

from .synthetic import make_scene
from .test_ba import build_obs_table
from .test_block_ba import _corridor

N = 4
NAMES = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")


def _problems() -> dict:
    """The four problems of tests/test_block_ba.py, as numpy."""
    out = {}
    intr, R, t, X, cam_id, pt_id, uv, w = _corridor()
    rng = np.random.default_rng(3)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    t0 = t + 0.02 * rng.standard_normal(t.shape).astype(np.float32)
    fixed = np.zeros(len(R), bool)
    fixed[0] = True
    out["corr"] = (intr, np.zeros(len(R), np.int32), R, t0, X0, cam_id, pt_id, uv, w, fixed)

    sc = make_scene(n_cams=8, n_points=96, noise_px=0.4)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    key = jax.random.PRNGKey(0)
    dR = se3.so3_exp_b(0.01 * jax.random.normal(key, (8, 3)))
    R0 = np.einsum("cij,cjk->cik", np.asarray(dR), sc.Rs.astype(np.float32))
    t0 = sc.ts.astype(np.float32) + 0.02 * np.asarray(jax.random.normal(key, (8, 3)))
    X0 = sc.points.astype(np.float32) + 0.03 * np.asarray(jax.random.normal(key, (96, 3)))
    fixed = np.zeros(8, bool)
    fixed[0] = True
    out["orbit"] = (sc.intrinsics.astype(np.float32)[None], np.zeros(8, np.int32),
                    R0.astype(np.float32), t0.astype(np.float32), X0.astype(np.float32),
                    cam_id, pt_id, uv, w, fixed)

    sc = make_scene(n_cams=16, n_points=400, noise_px=0.2, seed=7)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    guess = sc.intrinsics.astype(np.float32)[None].copy()
    guess[0, :2] *= 1.10
    fixed = np.zeros(16, bool)
    fixed[0] = True
    out["cal"] = (guess, np.zeros(16, np.int32), sc.Rs.astype(np.float32),
                  sc.ts.astype(np.float32), sc.points.astype(np.float32), cam_id, pt_id, uv, w,
                  fixed)

    intr, R, t, X, cam_id, pt_id, uv, w = _corridor(C=32, P=800, obs_per_cam=40)
    rng = np.random.default_rng(5)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    t0 = t + 0.02 * rng.standard_normal(t.shape).astype(np.float32)
    fixed = np.zeros(32, bool)
    fixed[0] = True
    out["ck"] = (intr, np.zeros(32, np.int32), R, t0, X0, cam_id, pt_id, uv, w, fixed)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    probs = _problems()
    d = tmp_path_factory.mktemp("block_ba")
    np.savez(d / "in.npz", **{f"{tag}_{k}": v for tag, p in probs.items()
                              for k, v in zip(NAMES, p)})
    tmesh.spawn(torch_dist_ranks.block_rank, N, str(d / "in.npz"), device="cpu",
                timeout=60, join_timeout=300)
    return probs, [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} virtual devices")
    return meshlib.make_mesh(block_ba.AXIS, jax.devices()[:N])


def _replicated(outs, tag, keys=("R", "t", "X", "costs")):
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(outs[0][f"{tag}_{k}"], o[f"{tag}_{k}"])


def _single_device(p, **kw):
    a = [jnp.asarray(x) for x in p]
    return lm.ba_solve(*a, **kw)


@pytest.mark.parametrize("tag,iters,floor_px,cut", [("corr", 10, 0.5, 0.1),
                                                    ("orbit", 12, None, 1e-2)])
def test_block_ba_parity(results, mesh4, tag, iters, floor_px, cut):
    """The corridor (small halo) and the orbit (all-see-all, the halo's
    worst case): the port's blocked solve against the reference's on the
    same four blocks (final cost 1e-3 relative), against the reference's
    single-device solver (5 %), per-rank point state ~1/n."""
    probs, outs = results
    p = probs[tag]
    _replicated(outs, tag)
    o = outs[0]
    *_, costs_ref, stats = block_ba.ba_solve_blocked(*p, mesh4, iters=iters, cg_iters=40)
    np.testing.assert_allclose(o[f"{tag}_costs"][-1], float(costs_ref[-1]), rtol=1e-3)
    assert o[f"{tag}_costs"][-1] < o[f"{tag}_costs"][0] * cut
    assert int(o[f"{tag}_pts_per_device"]) == stats["pts_per_device"]
    *_, costs_1 = _single_device(p, iters=iters, cg_iters=40)
    np.testing.assert_allclose(o[f"{tag}_costs"][-1], float(costs_1[-1]), rtol=0.05)
    if floor_px is not None:
        P = p[4].shape[0]
        assert stats["pts_per_device"] <= int(1.5 * P / N) + 16
        assert float(o[f"{tag}_halo"]) < 0.25
        a = [jnp.asarray(x) for x in p]
        rmse = lm.reprojection_rmse(a[0], a[1], jnp.asarray(o[f"{tag}_R"]),
                                    jnp.asarray(o[f"{tag}_t"]), jnp.asarray(o[f"{tag}_X"]),
                                    *a[5:9])
        assert float(rmse) < floor_px


def test_block_ba_joint_intrinsics(results, mesh4):
    """A 10 % focal error recovered by the point-sharded joint solver: the
    reference's gates (cost x0.05, focal within 2 % of the truth and 1 % of
    the single-device joint solve) and the reference's blocked solve's
    focal within 1e-4 relative, its final cost within 1e-3."""
    probs, outs = results
    p = probs["cal"]
    _replicated(outs, "cal", ("R", "t", "X", "intr", "costs"))
    o = outs[0]
    assert o["cal_costs"][-1] < o["cal_costs"][0] * 0.05
    f_blk = float(o["cal_intr"][0, 0])
    f_true = float(p[0][0, 0]) / 1.10
    assert abs(f_blk - f_true) / f_true < 0.02, f_blk
    _, _, _, intr_b, costs_b, _ = block_ba.ba_solve_blocked_intrinsics(
        *p, mesh4, params=("f",), iters=15, cg_iters=40)
    np.testing.assert_allclose(f_blk, float(np.asarray(intr_b)[0, 0]), rtol=1e-4)
    np.testing.assert_allclose(o["cal_costs"][-1], float(np.asarray(costs_b)[-1]), rtol=1e-3)
    a = [jnp.asarray(x) for x in p]
    _, _, _, intr2, costs2 = lm.ba_solve_intrinsics(*a, params=("f",), iters=15, cg_iters=40)
    assert abs(f_blk - float(intr2[0, 0])) / float(intr2[0, 0]) < 0.01
    np.testing.assert_allclose(o["cal_costs"][-1], float(costs2[-1]), rtol=0.1)


def test_block_ba_checkpoint_resume(results, mesh4):
    """Chunked checkpointing inside the distributed solve: 8 iterations in
    chunks of 4 give 9 costs; a run stopped after its first chunk saved an
    evolved damping at iteration 4, and resumed it runs the remaining chunk
    only (5 costs) and ends bit-identical to the uninterrupted run; the
    final cost within 1e-3 of the reference's chunked run."""
    probs, outs = results
    _replicated(outs, "cka")
    _replicated(outs, "ckb")
    o = outs[0]
    assert len(o["cka_costs"]) == 9
    assert int(o["ckb_mid_it"]) == 4
    assert float(o["ckb_mid_lam"]) != pytest.approx(1e-4)
    assert len(o["ckb_costs"]) == 5
    for k in ("R", "t", "X"):
        np.testing.assert_array_equal(o[f"ckb_{k}"], o[f"cka_{k}"])
    assert o["ckb_costs"][-1] == o["cka_costs"][-1]
    *_, costs_ref, _ = block_ba.ba_solve_blocked(*probs["ck"], mesh4, iters=8, cg_iters=30)
    np.testing.assert_allclose(o["cka_costs"][-1], float(costs_ref[-1]), rtol=1e-3)
