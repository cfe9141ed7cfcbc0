"""F18: the map build's geometric verification does not move with
``cfg.recon.seed``.

The reference's ``build_map`` calls ``verify_matches`` without a seed, so
its RANSAC keys start at ``PRNGKey(0)`` whatever the reconstruction's seed
is, and its verify stage's cache key leaves the seed out.  The port's
``build_front_end`` without a generator draws from one seeded 0 for the
same reason: verified matches, counts and tracks are equal at every
``recon.seed``, and a rebuild at another seed in the same work directory
(whose cached verify stage it reads) equals a fresh one.

The case: ``test_torch_pipeline._room_build_inputs`` (8 rendered room
frames at 160x120, window pairs), on the CPU.  Comparisons are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sfmx_torch.cli import pipeline as tp
from tests.test_torch_pipeline import _room_build_inputs

torch.set_num_threads(2)

SEEDS = (0, 5)


def _at_seed(cfg, seed):
    return dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon, seed=seed))


def _front_end(imgs, intr, cam_k, cfg, workdir=None):
    """(the verified matches' idx, verified valid, counts, obs_cam,
    obs_feat, obs_track) as numpy; idx where valid only (the stage cache
    keeps no other entry)."""
    _f, _p, res, cnt, tt = tp.build_front_end(imgs, intr, cam_k, cfg, "cpu", workdir)
    valid = res.valid.numpy()
    return (res.idx.numpy()[valid], valid, cnt.numpy(), tt.obs_cam, tt.obs_feat,
            tt.obs_track)


def _assert_equal(a, b):
    for name, x, y in zip(("idx", "valid", "counts", "obs_cam", "obs_feat", "obs_track"),
                          a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def room():
    return _room_build_inputs()


def _reference_tracks(imgs, intr, cam_k, cfg):
    """The reference's ``build_map`` up to its reconstruct stage: the track
    table and pair counts that stage would receive."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sfmx.cli import pipeline as jp
    from sfmx.cli.config import load_config as jload_config
    from sfmx.recon import incremental

    class Reached(Exception):
        pass

    seen = {}

    def stop(kp_uv, kp_mask, tt, intr, cam_k, rcfg, callbacks=None, pair_counts=None):
        seen.update(obs=(tt.obs_cam, tt.obs_feat, tt.obs_track), counts=pair_counts[1])
        raise Reached

    ov = ["match.pair_mode=window", f"match.window={cfg.match.window}",
          f"features.max_keypoints={cfg.features.max_keypoints}",
          f"recon.seed={cfg.recon.seed}"]
    orig, incremental.reconstruct = incremental.reconstruct, stop
    try:
        with pytest.raises(Reached):
            jp.build_map(imgs, intr, cam_k, jload_config(None, ov))
    finally:
        incremental.reconstruct = orig
    return seen


def test_verification_does_not_move_with_recon_seed(room):
    """Both packages at ``recon.seed`` 0 and 5: the reference's track table
    and per-pair verified counts are equal across the seeds, and so are the
    port's verified masks, counts and track tables."""
    imgs, intr, cam_k, cfg = room
    ref = [_reference_tracks(imgs, intr, cam_k, _at_seed(cfg, s)) for s in SEEDS]
    for x, y in zip(ref[0]["obs"], ref[1]["obs"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(ref[0]["counts"]), np.asarray(ref[1]["counts"]))
    port = [_front_end(imgs, intr, cam_k, _at_seed(cfg, s)) for s in SEEDS]
    _assert_equal(*port)
    assert port[0][1].sum() > 300


def test_rebuild_at_another_seed_in_one_workdir_equals_a_fresh_build(room, tmp_path):
    """A build at seed 0 and then at seed 5 in one work directory (the
    second reads the first's cached extract, pairs, match and verify
    stages) equals a fresh build at seed 5 without a work directory."""
    imgs, intr, cam_k, cfg = room
    _front_end(imgs, intr, cam_k, _at_seed(cfg, 0), tmp_path)
    cached = _front_end(imgs, intr, cam_k, _at_seed(cfg, 5), tmp_path)
    assert len(list((tmp_path / "stages").glob("verify-*.pkl"))) == 1
    _assert_equal(cached, _front_end(imgs, intr, cam_k, _at_seed(cfg, 5)))
