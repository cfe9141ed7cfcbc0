"""F15 (ROADMAP.md queue 3): config 5-serve's 128-frame sessions keep
landmarks far outside the 6 m room, which loosens the merge's verified
registration.  The fixture is the port's front end of session 2, the one
whose build at seed 0 keeps ten landmarks past 30 m on the port's own
draws and one on the reference's (``tests/f15_lockstep.py save``, then
``fixture``: the keypoints no track observes zeroed, which ``reconstruct``
never reads).

Both packages' ``reconstruct`` run on it at seed 0 with the same RANSAC
draws: the reference's Gumbel rows, its key splitting mirrored into the
port's draw sites (``f15_lockstep.run_port``).  Through the seed search and
the first round, where all but 11 cameras register and the far landmark
first lives, both register the same cameras, keep the same landmarks past
30 m (the same track ids), keep alive sets within 1 % of each other, and
place every camera centre within 1 cm.  Tolerance: both BAs on one input
end at the same cost within 1e-7 relative, but with one camera fixed the
scale is held only by the data, and f32 rounding moves the two-view seed's
cameras by up to 1.3 mm (``f15_lockstep.py ba``); the round compounds that
to 3.3 mm here.  So the far landmark is the build's, kept by both packages
alike under one draw: a sensitivity they share, not a stage of the port.
"""
from pathlib import Path

import numpy as np

from tests import f15_lockstep as ls

FIXTURE = Path(__file__).resolve().parent / "f15_session2.npz"
SEED = 0
ROUNDS = 1
CENTER_TOL_M = 0.01
ALIVE_TOL = 0.01


def test_same_far_landmarks_under_the_reference_draws():
    d = ls.load(FIXTURE)
    ref = ls.run_reference(d, SEED, rounds_only=ROUNDS)
    port = ls.run_port(d, SEED, ls.JaxDraws(SEED), rounds_only=ROUNDS)
    assert len(ref) == len(port) == ROUNDS
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a["registered"], b["registered"])
        assert a["registered"].sum() >= 100
        n_far, far_ref = ls.far(a["X"], a["alive"])
        assert n_far >= 1
        assert ls.far(b["X"], b["alive"])[1] == far_ref
        assert (a["alive"] ^ b["alive"]).sum() <= ALIVE_TOL * a["alive"].sum()
        both = a["registered"]
        dc = np.linalg.norm(ls.centers(a["R"], a["t"])[both] - ls.centers(b["R"], b["t"])[both],
                            axis=1)
        assert dc.max() < CENTER_TOL_M, dc.max()
