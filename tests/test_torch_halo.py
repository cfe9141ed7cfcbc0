"""Halo collectives of the port (``sfmx_torch.dist.halo``) in four gloo
ranks against the reference's ring collectives and ``psum`` on a 4-device
sub-mesh of the 8 virtual CPU devices, on the same inputs (the cases of
``tests/test_halo.py``).  The backends sum in their own order, so sums
agree within 1e-5; the gathered halo rows are copies, so they are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from sfmx.dist import halo, mesh as meshlib
from sfmx_torch.dist import mesh as tmesh
from tests import torch_dist_ranks

N = 4
CB, PLOCAL, HCAP = 4, 10, 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One world of four gloo ranks runs all three collectives; the inputs
    are per-rank stacks made from one seed."""
    rng = np.random.default_rng(0)
    z = dict(x_ar=rng.standard_normal((N, 16, 6, 6)).astype(np.float32),
             x_rs=rng.standard_normal((N, N * CB, 3)).astype(np.float32),
             vals=rng.standard_normal((N, PLOCAL, 3)).astype(np.float32),
             idx=rng.integers(0, PLOCAL, (N, HCAP)).astype(np.int64),
             msk=rng.random((N, HCAP)) < 0.7)
    d = tmp_path_factory.mktemp("halo")
    np.savez(d / "in.npz", **z)
    tmesh.spawn(torch_dist_ranks.halo_rank, N, str(d / "in.npz"), device="cpu",
                timeout=60, join_timeout=120)
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]
    return z, outs


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} virtual devices")
    return meshlib.make_mesh("blk", jax.devices()[:N])


def test_ring_all_reduce_matches_psum(results, mesh4):
    """Every rank's all-reduce equals the reference's ring all-reduce and
    its psum (1e-5)."""
    z, outs = results

    def f(xs):
        return halo.ring_all_reduce(xs, "blk"), jax.lax.psum(xs, "blk")

    fm = jax.jit(jax.shard_map(f, mesh=mesh4, in_specs=P("blk"),
                               out_specs=(P("blk"), P("blk"))))
    ring, dense = (np.asarray(a).reshape(N, 16, 6, 6)
                   for a in fm(jnp.asarray(z["x_ar"].reshape(N * 16, 6, 6))))
    for r in range(N):
        np.testing.assert_allclose(outs[r]["ring"], ring[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[r]["ring"], dense[r], rtol=1e-5, atol=1e-5)


def test_ring_reduce_scatter_owns_correct_chunk(results, mesh4):
    """Rank r gets chunk r of the sum over ranks, as the reference's ring
    leaves it (1e-5)."""
    z, outs = results
    fm = jax.jit(jax.shard_map(lambda xs: halo.ring_reduce_scatter(xs, "blk"), mesh=mesh4,
                               in_specs=P("blk"), out_specs=P("blk")))
    ref = np.asarray(fm(jnp.asarray(z["x_rs"].reshape(N * N * CB, 3)))).reshape(N, CB, 3)
    total = z["x_rs"].sum(axis=0).reshape(N, CB, 3)
    for r in range(N):
        np.testing.assert_allclose(outs[r]["own"], ref[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[r]["own"], total[r], rtol=1e-5, atol=1e-5)


def test_halo_gather_roundtrip(results, mesh4):
    """Every rank receives the same (n,Hcap,3) boundary set, equal to the
    reference's, in one all-gather; the reference's gathered masks are the
    stacked ``halo_mask`` every rank of the port already holds."""
    z, outs = results
    fm = jax.jit(jax.shard_map(lambda v, i, m: halo.halo_gather(v, i, m, "blk"), mesh=mesh4,
                               in_specs=(P("blk"), P("blk"), P("blk")),
                               out_specs=(P("blk"), P("blk"))))
    g, gm = fm(jnp.asarray(z["vals"].reshape(-1, 3)), jnp.asarray(z["idx"].reshape(-1), jnp.int32),
               jnp.asarray(z["msk"].reshape(-1)))
    g = np.asarray(g).reshape(N, N, HCAP, 3)[0]
    gm = np.asarray(gm).reshape(N, N, HCAP)[0]
    np.testing.assert_array_equal(gm, z["msk"])
    for r in range(N):
        np.testing.assert_array_equal(outs[r]["g"], g)
        for s in range(N):
            np.testing.assert_array_equal(outs[r]["g"][s],
                                          z["vals"][s][z["idx"][s]] * z["msk"][s][:, None])
