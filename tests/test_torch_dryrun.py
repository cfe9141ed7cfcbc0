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
