"""The port's observation-sharded BA (``sfmx_torch.dist.dist_ba``) and
data-parallel extraction in two gloo ranks, against the reference's
``make_ba_step`` on a 2-device sub-mesh of the 8 virtual CPU devices, on
the same inputs (``tests/test_dist.py``), and the two-process bootstrap of
``tests/test_multihost.py`` (the obs-sharded step across a real process
boundary).

Tolerances: the backends and the planes assembly sum in another order than
the reference's psum over its block pipeline, so costs agree within 1e-3
relative (the parity scene ends at the 0.4 px noise floor, where a last-bit
difference in a step moves the cost by ~1e-5 relative) and states within
1e-3 (rotations, translations; points 2e-3, map units); the two ranks
return bit-identical replicated results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.core import se3
from sfmx.dist import dist_ba, mesh as meshlib
from sfmx.kernels import features as jfeatures
from sfmx.solvers import lm
from sfmx_torch.dist import mesh as tmesh
from sfmx_torch.kernels import features
from tests import torch_dist_ranks

from .synthetic import make_scene
from .test_ba import build_obs_table

N = 2
NAMES = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")


def _parity_problem():
    """tests/test_dist.py's scene and start, padded to the world size."""
    sc = make_scene(n_cams=6, n_points=80, noise_px=0.4)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    cam_id, pt_id, uv, w = (meshlib.pad_to_multiple(a, N) for a in (cam_id, pt_id, uv, w))
    C, P = 6, 80
    key = jax.random.PRNGKey(0)
    dR = se3.so3_exp_b(0.01 * jax.random.normal(key, (C, 3)))
    R0 = np.asarray(jnp.einsum("cij,cjk->cik", dR, jnp.asarray(sc.Rs, jnp.float32)))
    t0 = np.asarray(jnp.asarray(sc.ts, jnp.float32) + 0.02 * jax.random.normal(key, (C, 3)))
    X0 = np.asarray(jnp.asarray(sc.points, jnp.float32) + 0.03 * jax.random.normal(key, (P, 3)))
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return (np.asarray(sc.intrinsics, np.float32)[None], np.zeros(C, np.int64), R0, t0, X0,
            cam_id.astype(np.int64), pt_id.astype(np.int64), uv.astype(np.float32),
            w.astype(np.float32), fixed)


def _bootstrap_problem():
    """tests/test_multihost.py's worker problem."""
    rng = np.random.default_rng(0)
    C, Pn, O = 6, 48, 64
    intr = np.asarray([[100.0, 100.0, 32.0, 24.0, 0, 0, 0]], np.float32)
    X = rng.uniform(-1, 1, (Pn, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (C, 3, 3)).copy()
    t = np.concatenate([rng.uniform(-0.2, 0.2, (C, 2)), np.full((C, 1), 4.0)], 1).astype(np.float32)
    cam_id = rng.integers(0, C, O).astype(np.int64)
    pt_id = rng.integers(0, Pn, O).astype(np.int64)
    Xc = X[pt_id] + t[cam_id]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0])).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return intr, np.zeros(C, np.int64), R, t, X, cam_id, pt_id, uv, np.ones(O, np.float32), fixed


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    z = {}
    for tag, prob in (("a", _parity_problem()), ("b", _bootstrap_problem())):
        z.update({f"{tag}_{k}": v for k, v in zip(NAMES, prob)})
    z["imgs"] = np.random.default_rng(0).random((8, 64, 96)).astype(np.float32)
    d = tmp_path_factory.mktemp("dist")
    np.savez(d / "in.npz", **z)
    tmesh.spawn(torch_dist_ranks.dist_rank, N, str(d / "in.npz"), device="cpu",
                timeout=60, join_timeout=240)
    return z, [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]


@pytest.fixture(scope="module")
def mesh2():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} virtual devices")
    return meshlib.make_mesh("obs", jax.devices()[:N])


def _reference_step(z, tag, mesh, **kw):
    a = [jnp.asarray(z[f"{tag}_{k}"]) for k in NAMES]
    a[1], a[5], a[6] = (x.astype(jnp.int32) for x in (a[1], a[5], a[6]))
    return [np.asarray(x) for x in dist_ba.make_ba_step(mesh, **kw)(*a)]


def _replicated(outs, tag):
    for k in ("R", "t", "X", "costs"):
        np.testing.assert_array_equal(outs[0][f"{tag}_{k}"], outs[1][f"{tag}_{k}"])


def test_sharded_ba_matches_reference(results, mesh2):
    """The parity scene (12 LM iterations x 40 CG steps): the port's
    two-rank step against the reference's on two devices — every cost of
    the trace within 1e-3 relative, the final states within 1e-3 / 2e-3 —
    and, as the reference's test, against the single-device solver (5 %)
    and at the noise floor."""
    z, outs = results
    _replicated(outs, "a")
    R, t, X, costs = _reference_step(z, "a", mesh2, iters=12, cg_iters=40)
    o = outs[0]
    np.testing.assert_allclose(o["a_costs"], costs, rtol=1e-3)
    np.testing.assert_allclose(o["a_R"], R, atol=1e-3)
    np.testing.assert_allclose(o["a_t"], t, atol=1e-3)
    np.testing.assert_allclose(o["a_X"], X, atol=2e-3)
    a = [jnp.asarray(z[f"a_{k}"]) for k in NAMES]
    a[1], a[5], a[6] = (x.astype(jnp.int32) for x in (a[1], a[5], a[6]))
    *_, costs_ref = lm.ba_solve(*a, iters=12, cg_iters=40)
    assert o["a_costs"][-1] < o["a_costs"][0] * 1e-2
    np.testing.assert_allclose(o["a_costs"][-1], float(costs_ref[-1]), rtol=0.05)
    rmse = lm.reprojection_rmse(a[0], a[1], jnp.asarray(o["a_R"]), jnp.asarray(o["a_t"]),
                                jnp.asarray(o["a_X"]), a[5], a[6], a[7], a[8])
    assert float(rmse) < 0.6


def test_two_process_bootstrap(results, mesh2):
    """The reference's two-process bootstrap problem across two processes:
    finite, not worse than its start, replicated bit for bit, and the cost
    trace within 1e-3 relative of the reference's two-device step."""
    z, outs = results
    _replicated(outs, "b")
    costs = outs[0]["b_costs"]
    assert np.isfinite(costs).all() and costs[-1] <= costs[0] * 1.01, costs
    ref = _reference_step(z, "b", mesh2, iters=2, cg_iters=5)[3]
    np.testing.assert_allclose(costs, ref, rtol=1e-3, atol=1e-12)


def test_data_parallel_extraction(results):
    """Each rank extracts its half of the batch and every rank gets all
    eight images' features: against the reference's extraction of the
    whole batch at test_torch_features.py's two-octave tolerance (matched
    as sets: >= 98 % of the reference's valid keypoints have one of the
    port's within 0.05 px, >= 98 % of their descriptors agree within atol
    1e-4 and all within 1e-3; F1 in ROADMAP.md), and bit-equal to the
    port's extraction of the same halves in one process."""
    z, outs = results
    imgs = z["imgs"]
    ref = jfeatures.detect_and_describe(jnp.asarray(imgs), max_keypoints=32, threshold=1e-9)
    for o in outs:
        assert o["desc"].shape == np.asarray(ref.desc).shape == (8, 32, jfeatures.N_FLOAT_DIM)
        assert not np.any(np.isnan(o["desc"]))
    np.testing.assert_array_equal(outs[0]["desc"], outs[1]["desc"])
    n_ok = n_ref = n_desc = n_desc_ok = 0
    for b in range(len(imgs)):
        rm, om = np.asarray(ref.kp.mask[b]), outs[0]["mask"][b]
        ruv, ouv = np.asarray(ref.kp.uv[b])[rm], outs[0]["uv"][b][om]
        d = np.linalg.norm(ruv[:, None] - ouv[None], axis=-1)
        j = d.argmin(axis=1)
        close = d[np.arange(len(ruv)), j] < 0.05
        n_ok += int(close.sum())
        n_ref += len(ruv)
        err = np.abs(outs[0]["desc"][b][om][j[close]] - np.asarray(ref.desc[b])[rm][close]).max(1)
        n_desc += len(err)
        n_desc_ok += int((err <= 1e-4).sum())
        assert err.max() <= 1e-3, err.max()
    assert n_ref > 100 and n_ok >= 0.98 * n_ref, (n_ok, n_ref)
    assert n_desc_ok >= 0.98 * n_desc, (n_desc_ok, n_desc)
    for h in range(N):
        f = features.detect_and_describe(torch.from_numpy(imgs[4 * h:4 * h + 4]),
                                         max_keypoints=32, threshold=1e-9)
        np.testing.assert_array_equal(outs[0]["desc"][4 * h:4 * h + 4], f.desc.numpy())
        np.testing.assert_array_equal(outs[0]["uv"][4 * h:4 * h + 4], f.kp.uv.numpy())
        np.testing.assert_array_equal(outs[0]["mask"][4 * h:4 * h + 4], f.kp.mask.numpy())
