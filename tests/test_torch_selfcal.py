"""S3 and S4 (ROADMAP.md queue 3): the 96-frame walk's self-calibration from
a focal 5 % high ends at +4.7 % on the card at seed 0, where the CPU's
builds land within 2 %.  The fixture is the card's: the walk's track table
and the state its ``reconstruct`` handed the joint pose, point and focal LM
(``chip_experiments/selfcal_state.py --capture``, then
``tests/s3_lockstep.py fixture``: the keypoints no track observes zeroed).

On the reference's RANSAC draws (``tests/s3_lockstep.py``) both packages'
seed searches pick the same pair at every seed measured, and from the card's
state both joint LMs stay as far off, each taking steps whose reduced system
is not positive definite in f32 (a CG step with pAp <= 0, whose clamped
alpha overflows the trial to a non-finite cost, which LM rejects).  So the
card's miss is a sensitivity both packages share, pinned here:

- the seed search and the first round at seed 0 on the reference's draws:
  the same seed pair and registered cameras within one;
- the joint LM from the card's state, ``JOINT_ITERS`` iterations of its 25:
  both foci within ``FOCAL_TOL_PX`` of each other, both still more than 3 %
  high, and each with a non-finite trial.  The tolerance is the reference's
  own spread: at 8 iterations the reference compiled ends at 586.681 px and
  evaluated eagerly (``jax.disable_jit``) at 586.500, the port at 586.679
  (over all 25: 586.434, 586.458 and 586.478).  Halving the port's step
  lengths or its focal step moves its focal 0.42 and 0.71 px and fails
  this; taking the trial ranking's parallax cap at 10 degrees instead of 15
  makes the port seed from (71, 89) and fails the first test.
"""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "chip_experiments"))

from tests import f15_lockstep as ls  # noqa: E402
from tests import s3_lockstep as s3  # noqa: E402

import selfcal_state as sc  # noqa: E402

torch.set_num_threads(2)
FIXTURE = Path(__file__).resolve().parent / "selfcal_walk_card.npz"
SEED = 0
ROUNDS = 1
JOINT_ITERS = 8
FOCAL_TOL_PX = 0.25


def _fixture() -> tuple[dict, dict]:
    z = dict(np.load(FIXTURE))
    state = {k[len("state_"):]: v for k, v in z.items() if k.startswith("state_")}
    walk = {k: v for k, v in z.items() if not k.startswith("state_")}
    walk["n_tracks"] = int(walk["n_tracks"])
    return walk, state


def test_seed_search_and_first_round_on_the_reference_draws():
    d, _ = _fixture()
    ref = ls.run_reference(d, SEED, rounds_only=ROUNDS, cfg_kw=s3.CFG_KW)
    port = ls.run_port(d, SEED, ls.JaxDraws(SEED), rounds_only=ROUNDS, cfg_kw=s3.CFG_KW)
    assert len(ref) == len(port) == ROUNDS
    pair_ref, pair_port = ref[0]["init_pairs"][0][:2], port[0]["init_pairs"][0][:2]
    assert tuple(pair_port) == tuple(pair_ref), (pair_port, pair_ref)
    for a, b in zip(ref, port):
        assert abs(int(a["registered"].sum()) - int(b["registered"].sum())) <= 1
        assert (a["registered"] ^ b["registered"]).sum() <= 1


def test_joint_lm_from_the_cards_state_stays_off_in_both():
    import jax.numpy as jnp

    from sfmx.solvers import lm as jlm
    from sfmx_torch.solvers import lm as tlm

    _, st = _fixture()
    kw = dict(sc.KW, iters=JOINT_ITERS)
    f0 = float(st["intr"][0, 0])
    _R, _t, _X, ji, jc = jlm.ba_solve_intrinsics(*(jnp.asarray(st[n]) for n in sc.NAMES), **kw)
    _R, _t, _X, ti, tc = tlm.ba_solve_intrinsics(*(torch.as_tensor(st[n]) for n in sc.NAMES),
                                                 **kw)
    f_ref, f_port = float(ji[0, 0]), float(ti[0, 0])
    assert abs(f_port - f_ref) < FOCAL_TOL_PX, (f_port, f_ref)
    for f in (f_ref, f_port):
        assert f < f0 and f / sc.FOCAL_TRUE - 1.0 > sc.MISS, f
    for costs in (np.asarray(jc), tc.numpy()):
        assert costs.shape == (JOINT_ITERS + 1,)
        assert np.isfinite(costs[0]) and (~np.isfinite(costs)).sum() >= 1, costs
        assert np.nanmin(costs) <= costs[0]
