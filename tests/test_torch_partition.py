"""Map partitioning and the block layout of the port
(``sfmx_torch.mapstore.partition``, ``sfmx_torch.dist.block_layout``),
host numpy copies of the reference's: every array bit-equal to
``sfmx``'s on the same inputs, and the properties of
``tests/test_partition.py`` and ``tests/test_block_ba.py``'s layout
round trip."""
import numpy as np
import pytest
import torch

from sfmx.dist import block_layout as jlayout
from sfmx.mapstore import partition as jpart
from sfmx_torch.dist import block_layout
from sfmx_torch.mapstore.partition import partition_trajectory, reorder_obs_by_block
from sfmx_torch.solvers import lm

from .synthetic import make_scene
from .test_ba import build_obs_table
from .test_block_ba import _corridor


def _windowed(C=32, P=400, seed=0):
    """tests/test_partition.py's corridor-style windowed covisibility."""
    rng = np.random.default_rng(seed)
    cam_id, pt_id = [], []
    for c in range(C):
        lo = min(int(c / C * P), P - 60)
        cam_id.append(np.full(40, c))
        pt_id.append(rng.choice(np.arange(lo, lo + 60), size=40, replace=False))
    return np.concatenate(cam_id).astype(np.int32), np.concatenate(pt_id).astype(np.int32)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (np.ndarray, int, np.integer)):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


def test_partition_balances_observations():
    sc = make_scene(n_cams=16, n_points=200, arc_deg=200.0)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    part = partition_trajectory(cam_id, pt_id, w > 0, 16, 200, 4)
    _equal(part, jpart.partition_trajectory(cam_id, pt_id, w > 0, 16, 200, 4))
    counts = part.block_obs_counts()
    assert counts.min() > 0.6 * counts.mean()
    assert counts.max() < 1.4 * counts.mean()
    assert set(part.cam_block.tolist()) == {0, 1, 2, 3}
    assert np.all(np.diff(part.cam_block) >= 0)


def test_halo_is_moderate_and_correct():
    cam_id, pt_id = _windowed()
    alive = np.ones(len(cam_id), bool)
    part = partition_trajectory(cam_id, pt_id, alive, 32, 400, 4)
    ref = jpart.partition_trajectory(cam_id, pt_id, alive, 32, 400, 4)
    _equal(part, ref)
    assert part.halo_fraction() == ref.halo_fraction()
    assert np.all(part.pt_block[pt_id[part.halo_obs]] != part.obs_block[part.halo_obs])
    assert 0.0 < part.halo_fraction() < 0.2


def test_block_reorder_preserves_ba_solution():
    """The reorder equals the reference's, and the port's BA ends at the
    same cost on either order (1e-3 relative, f32 reorder noise)."""
    sc = make_scene(n_cams=8, n_points=100, noise_px=0.4)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    part = partition_trajectory(cam_id, pt_id, w > 0, 8, 100, 4)
    got = reorder_obs_by_block(part, cam_id, pt_id, uv, w)
    for x, y in zip(got, jpart.reorder_obs_by_block(part, cam_id, pt_id, uv, w)):
        np.testing.assert_array_equal(x, y)
    T = torch.as_tensor
    fixed = torch.zeros(8, dtype=torch.bool)
    fixed[0] = True
    base = (T(sc.intrinsics, dtype=torch.float32)[None], torch.zeros(8, dtype=torch.int64),
            T(sc.Rs, dtype=torch.float32), T(sc.ts, dtype=torch.float32),
            T(sc.points, dtype=torch.float32))
    c1 = lm.ba_solve(*base, T(cam_id), T(pt_id), T(uv), T(w), fixed, iters=8, cg_iters=30)[3]
    c2 = lm.ba_solve(*base, *(T(a) for a in got[1:]), fixed, iters=8, cg_iters=30)[3]
    np.testing.assert_allclose(float(c1[-1]), float(c2[-1]), rtol=1e-3)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_block_layout_roundtrip(n_blocks):
    """Every field of the port's layout equals the reference's, every alive
    observation resolves to its camera, point and uv, and the scatters and
    gathers are inverse."""
    intr, R, t, X, cam_id, pt_id, uv, w = _corridor(C=16, P=300, obs_per_cam=25)
    w = w.copy()
    w[::17] = 0.0                                   # dead rows are dropped
    lay = block_layout.build_block_layout(cam_id, pt_id, uv, w, len(R), len(X), n_blocks)
    ref = jlayout.build_block_layout(cam_id, pt_id, uv, w, len(R), len(X), n_blocks)
    _equal(lay[:-1], ref[:-1])
    _equal(lay.part, ref.part)
    assert lay.stats() == ref.stats()
    n, cb, pb, hcap = lay.n_blocks, lay.cb, lay.pb, lay.hcap
    halo_global = np.full(n * hcap, -1, np.int64)
    for b in range(n):
        for s in range(hcap):
            if lay.halo_mask[b * hcap + s]:
                halo_global[b * hcap + s] = lay.pt_global[b * pb + lay.halo_idx[b * hcap + s]]
    got = []
    for i in np.flatnonzero(lay.obs_w > 0):
        b = i // lay.ob
        e = lay.obs_pt_ext[i]
        pt_g = lay.pt_global[b * pb + e] if e < pb else halo_global[e - pb]
        got.append((int(lay.cam_global[b * cb + lay.obs_cam_l[i]]), int(pt_g),
                    tuple(map(float, lay.obs_uv[i]))))
    alive = w > 0
    want = sorted((int(c), int(p), tuple(map(float, u)))
                  for c, p, u in zip(cam_id[alive], pt_id[alive], uv[alive]))
    assert sorted(got) == want
    assert pb <= int(1.5 * len(X) / n_blocks) + 16
    (X_l,) = block_layout.scatter_pts(lay, X)
    R_l, t_l = block_layout.scatter_cams(lay, R, t)
    np.testing.assert_array_equal(block_layout.gather_pts(lay, len(X), X_l)[0], X)
    np.testing.assert_array_equal(block_layout.gather_cams(lay, len(R), R_l, t_l)[1], t)
    for x, y in zip((X_l, R_l, t_l), (*jlayout.scatter_pts(ref, X), *jlayout.scatter_cams(ref, R, t))):
        np.testing.assert_array_equal(x, y)
