"""Two gloo ranks started apart, each its own ``subprocess.Popen`` of
``python -m sfmx_torch.dist.mesh`` joined over ``tcp://127.0.0.1:<port>``
(no ``spawn``, no ``file://`` store): the port's side of
``tests/test_multihost.py``, whose two processes join a coordinator
address.

The ranks run ``tests.torch_dist_ranks.apart_rank``: the observation-sharded
LM on the two-process bootstrap problem (``test_torch_dist.py``'s, held to
the same asserts: finite, not worse than its start, the ranks bit-identical,
the cost trace within 1e-3 relative of the reference's two-device step) and
the point-sharded block BA on ``test_multihost.py``'s corridor (6 LM x 20
CG; the reference's asserts: finite, below a tenth of its start, within 5 %
of the single-process solver; here also the ranks bit-identical).  Each
process has a timeout of its own and is killed past it.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from sfmx.solvers import lm
from tests.test_block_ba import _corridor
from tests.test_torch_dist import NAMES, _bootstrap_problem, _reference_step

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def corridor_problem():
    """``test_multihost.py``'s block-BA problem and start."""
    intr, R, t, X, cam_id, pt_id, uv, w = _corridor(C=32, P=800, obs_per_cam=40)
    rng = np.random.default_rng(5)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    t0 = t + 0.02 * rng.standard_normal(t.shape).astype(np.float32)
    fixed = np.zeros(len(R), bool)
    fixed[0] = True
    return (intr, np.zeros(len(R), np.int64), R, t0, X0, cam_id.astype(np.int64),
            pt_id.astype(np.int64), uv, w, fixed)


def run_apart(fn: str, inp: Path) -> list[str]:
    """Start WORLD ranks as separate processes against one tcp:// address;
    each is waited for RANK_TIMEOUT_S and killed past it.  Returns their
    outputs; a rank that fails or times out fails the test."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sfmx_torch.dist.mesh", fn, "--rank", str(r),
         "--world-size", str(WORLD), "--init-method", init, "--device", "cpu",
         "--timeout", "120", "--args", json.dumps([str(inp)])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    z = {}
    for tag, prob in (("b", _bootstrap_problem()), ("c", corridor_problem())):
        z.update({f"{tag}_{k}": v for k, v in zip(NAMES, prob)})
    d = tmp_path_factory.mktemp("apart")
    np.savez(d / "in.npz", **z)
    run_apart("tests.torch_dist_ranks:apart_rank", d / "in.npz")
    return z, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _same_bits(outs, tag):
    for k in ("R", "t", "X", "costs"):
        np.testing.assert_array_equal(outs[0][f"{tag}_{k}"], outs[1][f"{tag}_{k}"])


def test_apart_ranks_join_one_world(results):
    """Each process joined the same world of two under its own rank."""
    _, outs = results
    assert [int(o["world_size"]) for o in outs] == [WORLD] * WORLD
    assert [int(o["group_rank"]) for o in outs] == list(range(WORLD))


def test_apart_bootstrap_matches_reference(results):
    """The bootstrap problem across two processes started apart: finite,
    not worse than its start, replicated bit for bit, the cost trace within
    1e-3 relative of the reference's two-device step."""
    import jax

    from sfmx.dist import mesh as meshlib

    z, outs = results
    _same_bits(outs, "b")
    costs = outs[0]["b_costs"]
    assert np.isfinite(costs).all() and costs[-1] <= costs[0] * 1.01, costs
    mesh2 = meshlib.make_mesh("obs", jax.devices()[:WORLD])
    ref = _reference_step(z, "b", mesh2, iters=2, cg_iters=5)[3]
    np.testing.assert_allclose(costs, ref, rtol=1e-3, atol=1e-12)


def test_apart_block_ba_parity(results):
    """The point-sharded solve (halo all-gather, reduce-scatter) across the
    two processes: finite, below a tenth of its start, within 5 % of the
    reference's single-process solver, the ranks bit-identical."""
    z, outs = results
    _same_bits(outs, "c")
    costs = outs[0]["c_costs"]
    assert np.isfinite(costs).all() and costs[-1] < costs[0] * 0.1, costs
    assert 0.0 < float(outs[0]["c_halo"]) < 1.0
    a = [jnp.asarray(z[f"c_{k}"]) for k in NAMES]
    a[1], a[5], a[6] = (x.astype(jnp.int32) for x in (a[1], a[5], a[6]))
    ref = float(np.asarray(lm.ba_solve(*a, iters=6, cg_iters=20)[3])[-1])
    assert abs(float(costs[-1]) - ref) <= 0.05 * abs(ref), (costs[-1], ref)
