"""Checkpointed bundle adjustment on the CPU: ``sfmx_torch.solvers.ba_ckpt``
against ``sfmx.solvers.ba_ckpt``, checkpoint files exchanged between the
two packages, and a SIGKILL of a solving process that a new process
resumes.

Tolerances, and why:
- a chunked solve against one uninterrupted ``ba_solve`` of the port:
  bit-equal.  A chunk restarts from the saved state and f32 damping, and
  its first cost is the same arithmetic on the same values as the last
  accepted trial cost (on the dense path K8's cost of a candidate does not
  depend on its place among the candidates, ``test_torch_cost_groups``);
- the port's chunked solve against the reference's: the reprojection
  RMSE within 1e-3 relative (the reference's own tolerance between its
  resumed and uninterrupted solves), costs as in ``test_torch_ba``;
- checkpoint files: exact (the same npz fields and dtypes).
"""
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.solvers import ba_ckpt as jckpt
from sfmx.solvers import lm as jlm
from sfmx_torch.solvers import ba_ckpt as tckpt
from sfmx_torch.solvers import lm as tlm
from tests.test_ckpt import _problem

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def port_problem():
    return tuple(torch.from_numpy(np.array(a)) for a in _problem())


def _rmse(args, R, t, X):
    return float(tlm.reprojection_rmse(args[0], args[1], R, t, X, *args[5:9]))


@pytest.mark.parametrize("dense", [False, True])
def test_checkpoint_resume_matches_uninterrupted(tmp_path, dense):
    args = port_problem()
    kw = dict(tp_cap=8, dense_cg=True) if dense else {}
    lens = np.bincount(args[6].numpy())
    assert lens.max() <= 8
    p1 = tmp_path / "a.ckpt.npz"
    R_a, t_a, X_a, costs_a, ran_a = tckpt.ba_solve_checkpointed(
        *args, total_iters=12, ckpt_every=4, ckpt_path=p1, cg_iters=20, **kw)
    assert ran_a == 12 and len(costs_a) == 3 * 5

    # a crash after the first chunk: a new call resumes from the file
    p2 = tmp_path / "b.ckpt.npz"
    tckpt.ba_solve_checkpointed(*args, total_iters=4, ckpt_every=4, ckpt_path=p2,
                                cg_iters=20, **kw)
    R_b, t_b, X_b, costs_b, ran_b = tckpt.ba_solve_checkpointed(
        *args, total_iters=12, ckpt_every=4, ckpt_path=p2, cg_iters=20, **kw)
    assert ran_b == 8
    np.testing.assert_allclose(_rmse(args, R_a, t_a, X_a), _rmse(args, R_b, t_b, X_b), rtol=1e-3)
    # and both equal one uninterrupted solve bit for bit
    R_u, t_u, X_u, costs_u = tlm.ba_solve(*args, iters=12, cg_iters=20, **kw)
    for a, b, u in ((R_a, R_b, R_u), (t_a, t_b, t_u), (X_a, X_b, X_u)):
        assert torch.equal(a, u) and torch.equal(b, u)
    cu = costs_u.numpy()
    np.testing.assert_array_equal(costs_a, np.concatenate([cu[0:5], cu[4:9], cu[8:13]]))
    np.testing.assert_array_equal(costs_b, costs_a[5:])
    assert float(costs_u[-1]) < 0.1 * float(costs_u[0])


def test_checkpointed_solve_matches_reference(tmp_path):
    jargs = _problem()
    args = port_problem()
    R_r, t_r, X_r, costs_r, ran_r = jckpt.ba_solve_checkpointed(
        *jargs, total_iters=12, ckpt_every=4, ckpt_path=tmp_path / "ref.npz", cg_iters=20)
    R, t, X, costs, ran = tckpt.ba_solve_checkpointed(
        *args, total_iters=12, ckpt_every=4, ckpt_path=tmp_path / "port.npz", cg_iters=20)
    assert ran == ran_r == 12 and costs.shape == np.asarray(costs_r).shape
    ref_rmse = float(jlm.reprojection_rmse(jargs[0], jargs[1], R_r, t_r, X_r, *jargs[5:9]))
    np.testing.assert_allclose(_rmse(args, R, t, X), ref_rmse, rtol=1e-3)
    np.testing.assert_allclose(costs[0], np.asarray(costs_r)[0], rtol=1e-4)
    np.testing.assert_allclose(costs[-1], np.asarray(costs_r)[-1], rtol=0.02)
    assert np.abs(X.numpy() - np.asarray(X_r)).max() < 1e-3


def test_ckpt_roundtrip(tmp_path):
    p = tmp_path / "c.npz"
    R = np.random.default_rng(0).standard_normal((4, 3, 3)).astype(np.float32)
    tckpt.save_ckpt(p, torch.from_numpy(R), R[:, 0], R[:, :, 0], 3e-4, 7)
    R2, t2, X2, lam, it = tckpt.load_ckpt(p, "cpu")
    np.testing.assert_array_equal(R2.numpy(), R)
    np.testing.assert_array_equal(X2.numpy(), R[:, :, 0])
    assert R2.dtype == torch.float32 and lam == np.float32(3e-4) and it == 7
    with pytest.raises(TypeError):
        tckpt.load_ckpt(p)          # no default device


def test_ckpt_files_exchange_with_reference(tmp_path):
    """A checkpoint one package writes, the other loads, field for field;
    and a solve the reference checkpointed resumes in the port."""
    rng = np.random.default_rng(1)
    R = rng.standard_normal((5, 3, 3)).astype(np.float32)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    tckpt.save_ckpt(tmp_path / "port.npz", torch.from_numpy(R), torch.from_numpy(t),
                    torch.from_numpy(X), 2.5e-3, 9)
    jckpt.save_ckpt(tmp_path / "ref.npz", jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
                    2.5e-3, 9)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    Rj, tj, Xj, lamj, itj = jckpt.load_ckpt(tmp_path / "port.npz")
    Rt, tt, Xt, lamt, itt = tckpt.load_ckpt(tmp_path / "ref.npz", "cpu")
    np.testing.assert_array_equal(np.asarray(Rj), Rt.numpy())
    np.testing.assert_array_equal(np.asarray(Xj), Xt.numpy())
    assert (lamj, itj) == (lamt, itt) == (np.float32(2.5e-3), 9)

    # the reference runs the first chunk, the port resumes from its file
    jargs, args = _problem(), port_problem()
    p = tmp_path / "handoff.npz"
    jckpt.ba_solve_checkpointed(*jargs, total_iters=4, ckpt_every=4, ckpt_path=p, cg_iters=20)
    R_b, t_b, X_b, _, ran = tckpt.ba_solve_checkpointed(*args, total_iters=12, ckpt_every=4,
                                                        ckpt_path=p, cg_iters=20)
    assert ran == 8
    R_r, t_r, X_r, _, _ = jckpt.ba_solve_checkpointed(
        *jargs, total_iters=12, ckpt_every=4, ckpt_path=tmp_path / "whole.npz", cg_iters=20)
    ref_rmse = float(jlm.reprojection_rmse(jargs[0], jargs[1], R_r, t_r, X_r, *jargs[5:9]))
    np.testing.assert_allclose(_rmse(args, R_b, t_b, X_b), ref_rmse, rtol=1e-3)


def test_ba_fn_is_called_per_chunk(tmp_path):
    args = port_problem()
    seen = []

    def ba_fn(*a, iters, init_lambda):
        seen.append((iters, init_lambda))
        return tlm.ba_solve(*a, iters=iters, init_lambda=init_lambda, cg_iters=20,
                            return_lam=True)

    _, _, _, costs, ran = tckpt.ba_solve_checkpointed(
        *args, total_iters=10, ckpt_every=4, ckpt_path=tmp_path / "f.npz", ba_fn=ba_fn)
    assert ran == 10 and [n for n, _ in seen] == [4, 4, 2] and seen[0][1] == 1e-4
    assert len(costs) == 5 + 5 + 3


_WORKER = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, sys.argv[3])
    import numpy as np
    import torch
    import sfmx_torch.solvers.ba_ckpt as bc

    torch.set_num_threads(1)
    ckpt, slow = sys.argv[1], sys.argv[2] == "slow"
    orig_save = bc.save_ckpt

    def save_and_maybe_stall(*a, **kw):
        orig_save(*a, **kw)
        if slow:
            print("CKPT_WRITTEN", flush=True)
            time.sleep(60)   # window for the kill

    bc.save_ckpt = save_and_maybe_stall
    with np.load(sys.argv[4]) as z:
        args = tuple(torch.from_numpy(z[f"a{i}"]) for i in range(10))
    R, t, X, costs, ran = bc.ba_solve_checkpointed(
        *args, total_iters=12, ckpt_every=4, ckpt_path=ckpt, cg_iters=10)
    mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sfmx"))
    print("RAN", ran, "FIRST", float(costs[0]), "FINAL", float(costs[-1]),
          "FOREIGN", len(mods), flush=True)
""")


def test_sigkill_fault_injection(tmp_path):
    """SIGKILL a port process mid-solve (CPU, importing neither jax nor
    sfmx), restart it, and it resumes from the checkpoint and converges."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    prob = tmp_path / "problem.npz"
    np.savez(prob, **{f"a{i}": np.array(a) for i, a in enumerate(_problem())})
    ckpt = str(tmp_path / "ba.ckpt.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, str(script), ckpt]

    # run 1: stalls after the first checkpoint write; SIGKILL it there
    p = subprocess.Popen(cmd + ["slow", str(ROOT), str(prob)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.time()
    line = ""
    try:
        while time.time() - t0 < 60:
            line = p.stdout.readline()
            if "CKPT_WRITTEN" in line or not line:
                break
        assert "CKPT_WRITTEN" in line, "worker never wrote a checkpoint"
        assert os.path.exists(ckpt)
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)

    # run 2: resumes from the checkpoint (8 of 12 iterations) and finishes
    out = subprocess.run(cmd + ["fast", str(ROOT), str(prob)], env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    toks = out.stdout.split()
    ran = int(toks[toks.index("RAN") + 1])
    first = float(toks[toks.index("FIRST") + 1])
    final = float(toks[toks.index("FINAL") + 1])
    assert ran == 8, f"did not resume from checkpoint: ran {ran}"
    assert np.isfinite(final) and final <= first, (first, final)
    assert int(toks[toks.index("FOREIGN") + 1]) == 0, "the worker imported jax or sfmx"
