"""The four-card run's rank functions (``sfmx_torch.dist.worlds``, phases
34-40 of ``chip_smoke.py --cards 4``) in one world of four gloo ranks on
the CPU, at small sizes, against the reference's functions on a 4-device
sub-mesh of the 8 virtual CPU devices, on the same inputs.  The world is
spawned once; every phase writes each rank's results.

Tolerances: sums of the backends and of the reference's ring add in other
orders (1e-5); gathers are copies (equal).  Extraction as
``tests/test_torch_dist.py``: matched as sets against the reference (F1 in
ROADMAP.md), bit-equal to the port's one-process extraction of each
rank's slice.  Map-sharded localization: global indices equal to the
reference's outside near-ties (a best-to-second gap under 1e-5), n_inliers
equal, poses within 1e-4.  The BAs: final costs within 1e-3 relative of
the reference's sharded solvers (as ``tests/test_torch_block_ba.py`` and
``tests/test_torch_dist.py``), the refined focal within 1e-4 relative.
Every rank returns the same bits.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sfmx.dist import block_ba as jblock_ba
from sfmx.dist import dist_ba as jdist_ba
from sfmx.dist import halo as jhalo
from sfmx.dist import mesh as meshlib
from sfmx.dist.block_layout import build_block_layout
from sfmx.kernels import features as jfeatures
from sfmx.localize.localize import LocalizationMap as JMap
from sfmx.localize.sharded import AXIS, _localize_sharded_jit
from sfmx.localize.sharded import shard_localization_map as jshard
from sfmx_torch.dist import dryrun, mesh, worlds
from sfmx_torch.kernels import features
from sfmx_torch.localize.localize import LocalizationMap, localize_batch_streaming
from tests import smoke_scenes, torch_dist_ranks

from .test_block_ba import _corridor

N = 4
PHASES = ("collectives", "extract", "sharded", "block_ba", "obs_ba", "dryrun")
KH, NEAR_TIE = 64, 1e-5
INTR_Q = np.array([280.0, 280.0, 160.0, 120.0, 0, 0, 0], np.float32)


def _localization_case():
    """A map of 512 random unit descriptors at points 4-8 m ahead, and two
    queries that see 48 of them each (descriptors 0.02 off, projected from
    their own poses) beside 16 features of nothing."""
    rng = np.random.default_rng(1)
    Pn, C, K = 512, 8, 64
    X = np.concatenate([rng.uniform(-2, 2, (Pn, 2)), rng.uniform(4, 8, (Pn, 1))], 1)
    desc = rng.standard_normal((Pn, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cols = dict(X=X.astype(np.float32), lm_desc=desc.astype(np.float32),
                lm_alive=np.ones(Pn, bool),
                kf_gdesc=np.eye(C, 128, dtype=np.float32), kf_alive=np.ones(C, bool),
                kf_centers=np.zeros((C, 3), np.float32),
                kf_lm=rng.integers(0, Pn, (C, 32)).astype(np.int32),
                kf_lm_mask=np.ones((C, 32), bool))
    q_desc = rng.standard_normal((2, K, 128))
    q_uv = rng.uniform(0, 320, (2, K, 2))
    for b in range(2):
        ids = rng.choice(Pn, 48, replace=False)
        q_desc[b, :48] = desc[ids] + 0.02 * rng.standard_normal((48, 128))
        Xc = X[ids] + np.array([0.1 * b, -0.05, 0.2])
        q_uv[b, :48] = Xc[:, :2] / Xc[:, 2:3] * 280.0 + np.array([160.0, 120.0])
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(0)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k_, (KH, K)))
                       for k_ in jax.random.split(key, 2)])
    return cols, dict(q_desc=q_desc.astype(np.float32), q_uv=q_uv.astype(np.float32),
                      q_mask=np.ones((2, K), bool), intr=INTR_Q, gumbel=gumbel), key


def _ba_problem():
    """A small camera-local problem, 2,998 observations (pads to 3,000)."""
    p = smoke_scenes.ba_problem(16, 300, 2998, seed=0, window=4, perturb=0.03)
    return dict(intr=p["intr"], k_idx=p["k_idx"], R=p["R"], t=p["t"], X=p["X"],
                cam_id=p["cam_id"], pt_id=p["pt_id"], uv=p["uv"], w=p["w_valid"],
                fixed=p["fixed_cam_mask"])


def _corridor_problem():
    intr, R, t, X, cam_id, pt_id, uv, w = _corridor(C=32, P=800, obs_per_cam=40)
    rng = np.random.default_rng(5)
    fixed = np.zeros(32, bool)
    fixed[0] = True
    return dict(intr=intr, k_idx=np.zeros(32, np.int32), R=R,
                t=t + 0.02 * rng.standard_normal(t.shape).astype(np.float32),
                X=X + 0.05 * rng.standard_normal(X.shape).astype(np.float32),
                cam_id=cam_id, pt_id=pt_id, uv=uv, w=w, fixed=fixed)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("multicard")
    rng = np.random.default_rng(0)
    z = {}
    z["collectives"] = dict(sizes_mb=np.array([1 / 64, 1 / 4]), reps=2,
                            x=rng.standard_normal((N, 12)).astype(np.float32))
    z["extract"] = dict(frames=rng.random((8, 48, 64)).astype(np.float32),
                        sigma=np.array([2, 3, 4, 5, 6]), max_keypoints=32, threshold=1e-9,
                        n_octaves=1, reps=1)
    cols, q, key = _localization_case()
    z["sharded"] = dict(**{f"map_{k}": v for k, v in cols.items()}, **q, k_hyp=KH,
                        px_thresh=4.0, sim_thresh=0.75, min_inliers=12)
    z["block_ba"] = dict(**_corridor_problem(), iters=2, cg_iters=5, twice=True, k_iters=1,
                         ckpt_every=1, ckpt_dir=str(d))
    z["obs_ba"] = dict(**_ba_problem(), iters=2, cg_iters=5)
    for p, v in z.items():
        np.savez(d / f"{p}.npz", **v)
    mesh.spawn(torch_dist_ranks.multicard_rank, N, str(d), PHASES, device="cpu",
               timeout=60, join_timeout=240)
    return z, key, {p: worlds.load_results(d, p, N) for p in PHASES}


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} virtual devices")
    return jax.devices()[:N]


def _same_on_every_rank(outs, keys):
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(outs[0][k], o[k])


def test_collectives_match_reference(world, mesh4):
    """Phase 34: every rank's sum of the ranks' rows equals the reference's
    ring all-reduce (1e-5), its gather the rows in rank order; the sums of
    small integers at both sizes are exact; the timed sizes report finite
    bus bandwidths."""
    z, _, res = world
    x = z["collectives"]["x"]
    fm = jax.jit(jax.shard_map(lambda v: jhalo.ring_all_reduce(v, "blk"),
                               mesh=meshlib.make_mesh("blk", mesh4), in_specs=P("blk"),
                               out_specs=P("blk")))
    ref = np.asarray(fm(jnp.asarray(x.reshape(-1)))).reshape(N, -1)
    for r, o in enumerate(res["collectives"]):
        np.testing.assert_allclose(o["sum"], ref[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o["gather"], x.reshape(-1))
        for mb in (1 / 64, 1 / 4):
            assert bool(o[f"ar_exact_{mb:g}"])
            assert np.isfinite(o[f"ar_busbw_{mb:g}"]) and float(o[f"ag_busbw_{mb:g}"]) > 0


def test_extract_matches_reference(world):
    """Phase 35: the four ranks gather the same features of the 8 frames
    (two each); against the reference's extraction of the batch
    as sets (>= 98 % of its keypoints within 0.05 px, >= 98 % of their
    descriptors within 1e-4, all within 1e-3); each rank's slice bit-equal
    to the port's extraction of the same two frames in one process."""
    z, _, res = world
    e, outs = z["extract"], res["extract"]
    _same_on_every_rank(outs, ("desc", "uv", "mask", "digest"))
    assert all(json.loads(str(o["launches"])) == {} for o in outs)
    imgs = e["frames"]
    ref = jfeatures.detect_and_describe(jnp.asarray(imgs), max_keypoints=32, threshold=1e-9)
    o = outs[0]
    n_ok = n_ref = n_desc = n_desc_ok = 0
    for b in range(len(imgs)):
        rm, om = np.asarray(ref.kp.mask[b]), o["mask"][b]
        ruv, ouv = np.asarray(ref.kp.uv[b])[rm], o["uv"][b][om]
        d = np.linalg.norm(ruv[:, None] - ouv[None], axis=-1)
        j = d.argmin(axis=1)
        close = d[np.arange(len(ruv)), j] < 0.05
        n_ok += int(close.sum())
        n_ref += len(ruv)
        err = np.abs(o["desc"][b][om][j[close]] - np.asarray(ref.desc[b])[rm][close]).max(1)
        n_desc += len(err)
        n_desc_ok += int((err <= 1e-4).sum())
        assert err.max() <= 1e-3, err.max()
    assert n_ref > 100 and n_ok >= 0.98 * n_ref, (n_ok, n_ref)
    assert n_desc_ok >= 0.98 * n_desc, (n_desc_ok, n_desc)
    for r, orr in enumerate(outs):
        f = features.detect_and_describe(torch.from_numpy(imgs[2 * r:2 * r + 2]),
                                         max_keypoints=32, threshold=1e-9)
        assert str(orr["own_digest"]) == worlds.digest(f.desc, f.kp.uv, f.kp.mask)


def test_sharded_matches_reference(world, mesh4):
    """Phase 36: the map in four landmark shards, one batch through
    ``localize_batch_sharded`` with the reference's RANSAC draws: the
    global index equal to the reference's 4-device one outside near-ties,
    n_inliers equal, poses within 1e-4, and the same poses from the
    port's unsharded streaming path; the merged top-2 equal on every rank."""
    z, key, res = world
    s, outs = z["sharded"], res["sharded"]
    _same_on_every_rank(outs, ("s1", "ig", "s2", "X3", "alive", "idx", "res_R", "res_t",
                               "res_n_inliers"))
    o = outs[0]
    cols = {k[4:]: v for k, v in s.items() if k.startswith("map_")}
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    mesh = meshlib.make_mesh(AXIS, mesh4)
    ref, ridx = _localize_sharded_jit(
        jshard(jmap, mesh), jnp.asarray(s["q_desc"]), jnp.asarray(s["q_uv"]),
        jnp.asarray(s["q_mask"]), jnp.broadcast_to(jnp.asarray(INTR_Q), (2, 7)), key, mesh=mesh,
        k_hypotheses=KH, px_thresh=4.0, ratio=0.85, sim_thresh=0.75, min_inliers=12,
        interpret=True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()
    sim = bf(s["q_desc"].reshape(-1, 128)) @ bf(cols["lm_desc"]).T
    top = -np.sort(-sim, axis=1)[:, :2]
    clear = (top[:, 0] - top[:, 1]) >= NEAR_TIE
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(o["idx"].reshape(-1)[clear], np.asarray(ridx).reshape(-1)[clear])
    np.testing.assert_array_equal(o["res_n_inliers"], np.asarray(ref.n_inliers))
    assert (o["res_n_inliers"] >= 40).all()
    for name in ("R", "t", "center"):
        np.testing.assert_allclose(o[f"res_{name}"], np.asarray(getattr(ref, name)), atol=1e-4)
    T = lambda k: torch.from_numpy(np.asarray(s[k]))
    st = localize_batch_streaming(LocalizationMap.from_numpy(cols, "cpu"), T("q_desc"),
                                  T("q_uv"), T("q_mask"), T("intr"), gumbel=T("gumbel"),
                                  k_hypotheses=KH)
    np.testing.assert_array_equal(o["res_n_inliers"], st.n_inliers.numpy())
    np.testing.assert_allclose(o["res_center"], st.center.numpy(), atol=1e-4)
    assert int(o["p_local"]) == 512 // N


def test_block_ba_matches_reference(world, mesh4):
    """Phase 38: the point-sharded solve on four ranks, the same solve
    again bit for bit, the joint focal, and the checkpointed solve resumed
    after its first chunk bit-identical to the uninterrupted one; final
    costs against the reference's blocked solvers (1e-3, focal 1e-4)."""
    z, _, res = world
    p, outs = z["block_ba"], res["block_ba"]
    _same_on_every_rank(outs, ("R", "t", "X", "costs", "k_intr", "k_costs", "ck_costs",
                               "ck_resumed_costs"))
    o = outs[0]
    args = [p[k] for k in worlds.BA_NAMES]
    jm = meshlib.make_mesh(jblock_ba.AXIS, mesh4)
    *_, costs_ref, stats = jblock_ba.ba_solve_blocked(*args, jm, iters=2, cg_iters=5)
    np.testing.assert_allclose(o["costs"][-1], float(costs_ref[-1]), rtol=1e-3)
    assert o["costs"][-1] < o["costs"][0]
    assert json.loads(str(o["stats"])) == stats
    assert bool(o["repeat_equal"]) and bool(o["ck_equal"])
    assert len(o["ck_costs"]) == 3 and len(o["ck_resumed_costs"]) == 2
    _, _, _, intr_k, _, _ = jblock_ba.ba_solve_blocked_intrinsics(*args, jm, params=("f",),
                                                                  iters=1, cg_iters=5)
    np.testing.assert_allclose(o["k_intr"][0, 0], float(np.asarray(intr_k)[0, 0]), rtol=1e-4)
    assert int(o["rs_bytes"]) == N * int(o["hcap"]) * 12 == int(o["ag_bytes"])


def test_obs_ba_matches_reference(world, mesh4):
    """Phase 39: the observation-sharded solve on four ranks (its table
    padded by two dead rows) against the reference's 4-device step: every
    cost within 1e-3 relative, the state replicated bit for bit."""
    z, _, res = world
    p, outs = z["obs_ba"], res["obs_ba"]
    _same_on_every_rank(outs, ("R", "t", "X", "costs"))
    a = [jnp.asarray(p[k]) for k in worlds.BA_NAMES]
    for i in (5, 6, 7, 8):
        a[i] = jnp.asarray(meshlib.pad_to_multiple(np.asarray(a[i]), N))
    a[1], a[5], a[6] = (x.astype(jnp.int32) for x in (a[1], a[5], a[6]))
    costs = np.asarray(jdist_ba.make_ba_step(meshlib.make_mesh("obs", mesh4), iters=2,
                                             cg_iters=5)(*a)[3])
    np.testing.assert_allclose(outs[0]["costs"], costs, rtol=1e-3)
    assert outs[0]["costs"][-1] < outs[0]["costs"][0]


def test_dryrun_world_of_four(world):
    """Phase 40: the dry run on four ranks: every rank's results equal, the
    block layout's statistics the reference's for four blocks, each BA's
    costs above rounding (the observations carry 0.5 px of seeded noise,
    so a card's costs and a CPU's can be held to 1e-4) and falling, and
    the map-sharded poses those of the unsharded streaming path on the
    same seeded map, queries and noise (drawn on the CPU: the same draw in
    every process and on every device)."""
    _, _, res = world
    outs = [json.loads(str(o["json"])) for o in res["dryrun"]]
    assert all(o == outs[0] for o in outs[1:])
    o = outs[0]
    for k in ("block_ba", "block_ba_k", "obs_ba"):
        c = np.asarray(o[k]["costs"])
        assert c[0] > 1e-5 and c[-1] < c[0], (k, c)
    rng = np.random.default_rng(7)
    C, Pn = 4 * N, 40 * N
    O = 24 * C
    rng.uniform(-5, 5, (Pn, 3))
    rng.uniform(-1, 1, (C, 2))
    cam = np.repeat(np.arange(C, dtype=np.int32), O // C)
    pt = ((cam.astype(np.int64) * (Pn - 20) // C) + rng.integers(0, 20, O)).astype(np.int32)
    stats = build_block_layout(cam, pt, np.zeros((O, 2), np.float32), np.ones(O, np.float32),
                               C, Pn, N).stats()
    assert {k: o["block_ba"][k] for k in stats} == stats
    lmap, qd, quv, qm, intr, g = dryrun.sharded_case(N)
    st = localize_batch_streaming(lmap, torch.from_numpy(qd), torch.from_numpy(quv),
                                  torch.from_numpy(qm), torch.from_numpy(intr), gumbel=g,
                                  k_hypotheses=g.shape[1])
    np.testing.assert_allclose(o["sharded"]["t"], st.t.numpy(), atol=1e-4)
