"""Map-sharded localization of the port (``sfmx_torch.localize.sharded``) in
two gloo ranks against the reference's on a 2-device sub-mesh of the 8
virtual CPU devices (its jnp oracle, ``interpret``), on the same rendered
room map and queries with the reference's RANSAC draws
(``tests/test_localize_sharded.py``).  The port's ranks run the plain
version of K4 on their shards.

Tolerances: the global top-2 index of every query feature equals the
reference's outside near-ties (a best-to-second gap under 1e-5, where the
two GEMMs' summation order may swap the winner); n_inliers are equal and
poses within the localization tests' 1e-4, against the reference and
against the port's unsharded streaming path; the ranks agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.dist import mesh as meshlib
from sfmx.localize.sharded import AXIS, _localize_sharded_jit
from sfmx.localize.sharded import shard_localization_map as jshard
from sfmx_torch.dist import mesh as tmesh
from sfmx_torch.localize.localize import localize_batch_streaming
from sfmx_torch.localize.sharded import shard_localization_map
from tests import torch_dist_ranks

from .test_torch_serve import INTR, room_map  # noqa: F401  (fixture reuse)

N, KH = 2, 256
NEAR_TIE = 1e-5


def _gumbel(key, B, K):
    return np.stack([np.asarray(jax.random.gumbel(k_, (KH, K)))
                     for k_ in jax.random.split(key, B)])


@pytest.fixture(scope="module")
def results(room_map, tmp_path_factory):  # noqa: F811
    q_desc, q_uv, q_mask = room_map["q"]
    key = jax.random.PRNGKey(0)
    z = {f"map_{k}": v for k, v in room_map["tmap"].to_numpy().items()}
    z.update(q_desc=q_desc, q_uv=q_uv, q_mask=q_mask, intr=INTR,
             gumbel=_gumbel(key, len(q_desc), q_desc.shape[1]), k_hyp=KH)
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "in.npz", **z)
    tmesh.spawn(torch_dist_ranks.sharded_rank, N, str(d / "in.npz"), device="cpu",
                timeout=60, join_timeout=180)
    return z, key, [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]


def test_sharded_matches_reference_and_streaming(room_map, results):  # noqa: F811
    z, key, outs = results
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    o = outs[0]
    mesh = meshlib.make_mesh(AXIS, jax.devices()[:N])
    B = len(z["q_desc"])
    ref, ridx = _localize_sharded_jit(
        jshard(room_map["jmap"], mesh), jnp.asarray(z["q_desc"]), jnp.asarray(z["q_uv"]),
        jnp.asarray(z["q_mask"]), jnp.broadcast_to(jnp.asarray(INTR), (B, 7)), key, mesh=mesh,
        k_hypotheses=KH, px_thresh=4.0, ratio=0.85, sim_thresh=0.75, min_inliers=12,
        interpret=True)
    # near-ties from the bf16-rounded scores in float64
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()
    q = np.where(z["q_mask"][..., None], z["q_desc"], 0.0).reshape(-1, z["q_desc"].shape[-1])
    pool = np.where(z["map_lm_alive"][:, None], z["map_lm_desc"], 0.0)
    sim = bf(q.astype(np.float32)) @ bf(pool.astype(np.float32)).T
    top = -np.sort(-sim, axis=1)[:, :2]
    real = z["q_mask"].reshape(-1)
    # masked rows score 0 everywhere: both packages keep the lowest index
    clear = ~real | ((top[:, 0] - top[:, 1]) >= NEAR_TIE)
    assert clear[real].mean() > 0.9
    np.testing.assert_array_equal(o["idx"].reshape(-1)[clear], np.asarray(ridx).reshape(-1)[clear])
    np.testing.assert_array_equal(o["res_n_inliers"], np.asarray(ref.n_inliers))
    for name in ("R", "t", "center"):
        np.testing.assert_allclose(o[f"res_{name}"], np.asarray(getattr(ref, name)), atol=1e-4)
    eyes = np.stack([p[2] for p in room_map["q_poses"]])
    assert (np.linalg.norm(o["res_center"] - eyes, axis=1) < 0.05).all()
    assert (o["res_n_inliers"] > 20).all()
    T = lambda k: torch.from_numpy(np.asarray(z[k]))
    st = localize_batch_streaming(room_map["tmap"], T("q_desc"), T("q_uv"), T("q_mask"), T("intr"),
                                  gumbel=T("gumbel"), k_hypotheses=KH)
    np.testing.assert_array_equal(o["res_n_inliers"], st.n_inliers.numpy())
    np.testing.assert_allclose(o["res_center"], st.center.numpy(), atol=1e-4)


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_pool_padding(room_map, results, n):  # noqa: F811
    """P not divisible by the world: the pool is padded with dead rows that
    are never matched; the shards concatenate to the padded map, their
    alive rows to the map's; the reference's 8-device placement alike.
    The two gloo ranks' shards hold ceil(P / 2) rows."""
    lmap = room_map["tmap"]
    P = lmap.X.shape[0]
    shards = [shard_localization_map(lmap, r, n, "cpu") for r in range(n)]
    pl = -(-P // n)
    assert all(s.X.shape[0] == pl for s in shards)
    X = torch.cat([s.X for s in shards])
    np.testing.assert_array_equal(X[:P].numpy(), lmap.X.numpy())
    assert not torch.cat([s.lm_alive for s in shards])[P:].any()
    assert int(sum(s.lm_alive.sum() for s in shards)) == int(lmap.lm_alive.sum())
    assert all(torch.equal(s.kf_lm, lmap.kf_lm) for s in shards)
    if n == 8:
        ref = jshard(room_map["jmap"], meshlib.make_mesh(AXIS))
        assert ref.X.shape[0] == X.shape[0] and ref.X.shape[0] % 8 == 0
        assert int(np.asarray(ref.lm_alive).sum()) == int(lmap.lm_alive.sum())
    _, _, outs = results
    assert all(int(o["p_local"]) == -(-P // N) for o in outs)
    assert sum(int(o["n_alive"]) for o in outs) == int(lmap.lm_alive.sum())
