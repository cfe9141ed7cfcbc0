"""F17 (ROADMAP.md queue 3): the front end's verification and tracks in
lockstep with the reference's, on a 48-frame slice of config 4's corridor.

The fixture ``tests/f17_corridor48.npz`` holds the reference's keypoints,
retrieval pair list (k 6, window 12 = ``window_for(48, "corridor", 4)``)
and raw matches on the walk ``run_configs.walk(48, "corridor", 4)`` at
320x240 (``tests/f17_front_end.py fixture``).  Both packages' verification
runs on them, the port's fed the reference's own Gumbel rows (per chunk of
256 at s, ``jax.random.split(PRNGKey(s), 256)``), and both build tracks
on their verified matches.

Bounds, and why.  On the same inputs and draws the two verifications still
part on some pairs: a pair's 256 hypotheses often tie or nearly tie on
their inlier counts, and the last bits of the 8-point solves (a batched
9x9 Cholesky, 3x3 SVDs) decide which one wins, and so which inlier set is
kept.  The reference parts from itself the same way: its chunk evaluated
eagerly (``jax.disable_jit``), same inputs and keys, keeps equal masks on
0.913 of these pairs against its jitted chunk's, and the port 0.901; under
another verification seed the reference keeps 0.559.  So: equal inlier
masks on >= 0.85 of the pairs; total inliers within 2 % and pairs kept
within 5 %; the port's tracks on the reference's verified matches equal to
the reference's table, and each package's tracks on its own verified
matches within 2 % in count.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.f17_front_end import VERIFY_CHUNK, intrinsics, overrides, ref_gumbel_rows

FIXTURE = Path(__file__).with_name("f17_corridor48.npz")
EQUAL_MASKS_SHARE = 0.85
INLIERS_REL, KEPT_REL, TRACKS_REL = 0.02, 0.05, 0.02

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    z = np.load(FIXTURE)
    frames = int(z["frames"])
    pairs = z["pairs"]
    K = z["kp_uv"].shape[1]
    valid = np.unpackbits(z["raw_valid"], count=len(pairs) * K).reshape(-1, K).astype(bool)
    idx = np.zeros(valid.shape, np.int32)
    idx[valid] = z["raw_idx"]
    return dict(frames=frames, uv=z["kp_uv"], mask=z["kp_mask"], pairs=pairs, idx=idx,
                valid=valid, intr=intrinsics(frames), ov=overrides(frames))


@pytest.fixture(scope="module")
def reference(case):
    """The reference's ``verify_matches`` (its own keys, seed 0, chunks of
    256) and ``build_tracks``."""
    import jax.numpy as jnp

    from sfmx.cli import pipeline as jp
    from sfmx.cli.config import load_config
    from sfmx.kernels.features import Features, Keypoints
    from sfmx.kernels.matching import MatchResult
    from sfmx.recon.tracks import build_tracks

    cfg = load_config(None, case["ov"])
    z = jnp.zeros(case["mask"].shape)
    feats = Features(Keypoints(jnp.asarray(case["uv"]), z.astype(jnp.int32), z, z, z,
                               jnp.asarray(case["mask"])), None, None)
    res = MatchResult(idx=jnp.asarray(case["idx"]), valid=jnp.asarray(case["valid"]), score=None)
    v, cnt = jp.verify_matches(feats, case["pairs"], res, case["intr"],
                               np.zeros(case["frames"], np.int32), cfg)
    valid = np.asarray(v.valid)
    tt = build_tracks(case["pairs"], case["idx"], valid, case["frames"],
                      cfg.features.max_keypoints)
    return valid, np.asarray(cnt), tt


@pytest.fixture(scope="module")
def port(case):
    """The port's ``verify_matches`` on the reference's draws, then its
    ``build_tracks``."""
    from sfmx_torch.cli import pipeline as tp
    from sfmx_torch.cli.config import load_config
    from sfmx_torch.kernels.features import Features, Keypoints
    from sfmx_torch.kernels.matching import MatchResult
    from sfmx_torch.recon.tracks import build_tracks

    cfg = load_config(None, case["ov"])
    z = torch.zeros(case["mask"].shape)
    feats = Features(Keypoints(torch.as_tensor(case["uv"]), z.long(), z, z, z,
                               torch.as_tensor(case["mask"])), z, z)
    n, K = case["valid"].shape
    g = torch.as_tensor(np.concatenate([
        ref_gumbel_rows(s, min(VERIFY_CHUNK, n - s), cfg.match.gv_hypotheses, K)
        for s in range(0, n, VERIFY_CHUNK)]))
    res = MatchResult(idx=torch.as_tensor(case["idx"]).long(),
                      valid=torch.as_tensor(case["valid"]), score=torch.zeros((n, K)))
    v, cnt = tp.verify_matches(feats, case["pairs"], res, case["intr"],
                               np.zeros(case["frames"], np.int32), cfg, gumbel=g)
    valid = v.valid.numpy()
    return valid, cnt.numpy(), lambda vv: build_tracks(case["pairs"], case["idx"], vv,
                                                       case["frames"], K)


def test_verification_on_the_reference_draws_agrees(case, reference, port):
    from sfmx_torch.cli.config import load_config

    (rv, rcnt, _), (pv, pcnt, _) = reference, port
    min_inliers = load_config(None, case["ov"]).match.gv_min_inliers
    equal = (rv == pv).all(axis=1).mean()
    assert equal >= EQUAL_MASKS_SHARE, equal
    assert abs(int(pv.sum()) - int(rv.sum())) <= INLIERS_REL * rv.sum(), (pv.sum(), rv.sum())
    kr, kp = int((rcnt >= min_inliers).sum()), int((pcnt >= min_inliers).sum())
    assert abs(kp - kr) <= KEPT_REL * kr, (kp, kr)
    # a pair below the minimum keeps nothing, in both
    assert not pv[pcnt < min_inliers].any() and not rv[rcnt < min_inliers].any()


def test_tracks_on_the_verified_matches_agree(reference, port):
    (rv, _, rtt), (pv, _, tracks) = reference, port
    same = tracks(rv)
    assert same.n_tracks == rtt.n_tracks
    for k in ("obs_cam", "obs_feat", "obs_track"):
        np.testing.assert_array_equal(getattr(same, k), np.asarray(getattr(rtt, k)), err_msg=k)
    own = tracks(pv)
    assert abs(own.n_tracks - rtt.n_tracks) <= TRACKS_REL * rtt.n_tracks, \
        (own.n_tracks, rtt.n_tracks)
