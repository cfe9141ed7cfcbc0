"""The port's multi-device dry run (``sfmx_torch.dist.dryrun``, the
counterpart of ``__graft_entry__.dryrun_multichip``) in two gloo ranks:
every path ran and returned finite results, the block layout's statistics
equal the reference's layout of the same problem, and no path made its
cost worse."""
import json

import numpy as np

from sfmx.dist.block_layout import build_block_layout
from sfmx_torch.dist import dryrun, mesh


def test_dryrun_two_gloo_ranks(tmp_path):
    out = tmp_path / "dryrun.json"
    mesh.spawn(dryrun.dryrun, 2, str(out), device="cpu", timeout=60, join_timeout=240)
    res = json.loads(out.read_text())
    assert set(res) == {"block_ba", "block_ba_k", "obs_ba", "dp", "sharded", "launches"}
    assert res["launches"] == {}            # CPU tensors: every wrapper ran its plain version
    for k in ("block_ba", "block_ba_k", "obs_ba"):
        c = np.asarray(res[k]["costs"])
        assert len(c) == 3 and np.isfinite(c).all() and c[-1] <= c[0] + 1e-12, (k, c)
    # the dry run's block problem, laid out by the reference for two blocks
    rng = np.random.default_rng(7)
    C, P = 8, 80
    O = 24 * C
    X = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-1, 1, (C, 2)), np.full((C, 1), 15.0)], 1)
    cam = np.repeat(np.arange(C, dtype=np.int32), O // C)
    pt = ((cam.astype(np.int64) * (P - 20) // C) + rng.integers(0, 20, O)).astype(np.int32)
    Xc = X[pt] + t[cam]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0])).astype(np.float32)
    stats = build_block_layout(cam, pt, uv, np.ones(O, np.float32), C, P, 2).stats()
    assert {k: res["block_ba"][k] for k in stats} == stats
    assert res["block_ba"]["pts_per_device"] < P
    assert abs(res["block_ba_k"]["focal"] - 100.0) < 1.0
    assert res["dp"]["keypoints"] > 0
    assert np.isfinite(res["sharded"]["t"]).all() and 0 <= res["sharded"]["idx_max"] < 128


def _obs_costs(X, t, cam, pt, uv):
    import torch

    from sfmx_torch.solvers import lm

    C = t.shape[0]
    fixed = np.zeros(C, bool)
    fixed[0] = True
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    *_, costs = lm.ba_solve(T([[100.0, 100.0, 32.0, 24.0, 0, 0, 0]]), T(np.zeros(C), torch.int64),
                            T(np.tile(np.eye(3), (C, 1, 1))), T(t), T(X),
                            T(cam, torch.int64), T(pt, torch.int64), T(uv), T(np.ones(len(pt))),
                            T(fixed, torch.bool), iters=2, cg_iters=5)
    return costs.numpy()


def test_dryrun_obs_problem_holds_a_ulp():
    """F11: the reference's observation-sharded dry-run table (16n random
    (camera, point) pairs over 64 points, most points seen once or never)
    is so underdetermined that moving X by 1e-7 relative moves the costs
    after an LM step by more than 1e-4 relative (~1e-3), so a card's world
    and a CPU's cannot agree to the 1e-4 that ``chip_smoke.py`` phase 40
    holds them to; the port's dry run sees each of 4n points from four
    distinct cameras, and the same move stays under 1e-4 (~3e-5)."""
    n = 4
    X, t, cam, pt, uv = dryrun.obs_problem(n, np.random.default_rng(0))
    ref_like = np.random.default_rng(0)
    Xr = ref_like.uniform(-1, 1, (64, 3)).astype(np.float32)
    tr = t.copy()
    camr, ptr = ref_like.integers(0, 8, 16 * n), ref_like.integers(0, 64, 16 * n)
    Xc = Xr[ptr] + tr[camr]
    uvr = (Xc[:, :2] / Xc[:, 2:3]) * 100.0 + np.asarray([32.0, 24.0]) \
        + dryrun._pixel_noise(9, 16 * n)
    for (X_, t_, c_, p_, uv_), worse in (((X, t, cam, pt, uv), False),
                                         ((Xr, tr, camr, ptr, uvr), True)):
        base = _obs_costs(X_, t_, c_, p_, uv_)
        moved = max(float(np.max(np.abs(_obs_costs(X_ * (1 + e), t_, c_, p_, uv_) - base)
                                 / base)) for e in (1e-7, -1e-7))
        assert (moved > 1e-4) == worse, moved
