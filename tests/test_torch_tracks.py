"""Track building: the port's native builder (``native/tracks.cpp`` through
its own g++ loader) and its numpy union-find against ``sfmx``'s
``build_tracks`` on the same match arrays.  Track tables compare as
canonical track sets (each track a sorted tuple of (image, feature)
observations; track ids are a numbering and may differ), covisibility
counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching as jm
from sfmx.recon import tracks as jtracks
from sfmx_torch.recon import _native_tracks
from sfmx_torch.recon import tracks as ttracks
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)


def canonical(tt):
    starts, ends = tt.track_slices()
    return sorted(tuple(sorted(zip(tt.obs_cam[s:e].tolist(), tt.obs_feat[s:e].tolist())))
                  for s, e in zip(starts, ends))


def _matched_scene(rng, n_cams, n_points, corrupt=0.0):
    """Exhaustive pairs of a synthetic scene matched by the reference's
    dense matcher; ``corrupt`` of the accepted matches re-pointed at random
    features (wrong edges the conflict rule has to handle)."""
    sc = make_scene(n_cams=n_cams, n_points=n_points)
    uv, desc, mask, feat_pt = scene_features(sc, rng)
    pairs = np.array([(a, b) for a in range(n_cams) for b in range(a + 1, n_cams)], np.int32)
    res = jm.match_pairs_float(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(pairs))
    idx, valid = np.array(res.idx), np.array(res.valid)
    if corrupt:
        r, c = np.nonzero(valid)
        pick = rng.random(len(r)) < corrupt
        idx[r[pick], c[pick]] = rng.integers(0, desc.shape[1], size=int(pick.sum()))
    return pairs, idx, valid, desc.shape[1], feat_pt


@pytest.mark.parametrize("n_cams,n_points,corrupt,min_length", [
    (4, 100, 0.0, 2), (5, 120, 0.0, 2), (6, 150, 0.15, 2), (6, 150, 0.15, 3)])
def test_native_numpy_and_reference_give_the_same_tracks(rng, n_cams, n_points, corrupt,
                                                         min_length):
    """native == numpy == sfmx, with and without corrupted edges (which the
    conflict-aware union rejects the same way in all three)."""
    pairs, idx, valid, K, _ = _matched_scene(rng, n_cams, n_points, corrupt)
    ref = jtracks.build_tracks(pairs, idx, valid, n_cams, K, min_length=min_length)
    nat = ttracks.build_tracks(pairs, idx, valid, n_cams, K, min_length=min_length)
    npy = ttracks.build_tracks(pairs, idx, valid, n_cams, K, min_length=min_length,
                               impl="numpy")
    assert ref.n_tracks > 20
    assert nat.n_tracks == npy.n_tracks == ref.n_tracks
    assert canonical(nat) == canonical(npy) == canonical(ref)
    for tt in (nat, npy):
        assert tt.obs_cam.dtype == np.int32 and np.all(np.diff(tt.obs_track) >= 0)
        starts, ends = tt.track_slices()
        assert np.all(ends - starts >= min_length)
        # no track holds two features of one image
        for s, e in zip(starts, ends):
            assert len(set(tt.obs_cam[s:e].tolist())) == e - s


def test_covisibility_counts_match_reference(rng):
    pairs, idx, valid, K, _ = _matched_scene(rng, 5, 120, 0.05)
    ref_tt = jtracks.build_tracks(pairs, idx, valid, 5, K)
    tt = ttracks.build_tracks(pairs, idx, valid, 5, K)
    ref = jtracks.covisibility_counts(ref_tt, 5)
    np.testing.assert_array_equal(ttracks.covisibility_counts(tt, 5), ref)
    np.testing.assert_array_equal(ttracks.covisibility_counts(tt, 5, impl="numpy"), ref)
    assert np.all(ref == ref.T) and ref.sum() > 0


def test_tracks_are_pure_on_true_matches(rng):
    """test_matching_tracks' merge-and-filter case on the port: every track
    observes one ground-truth landmark (> 97%)."""
    pairs, idx, valid, K, feat_pt = _matched_scene(rng, 4, 100)
    tt = ttracks.build_tracks(pairs, idx, valid, 4, K)
    assert tt.n_tracks > 30
    starts, ends = tt.track_slices()
    pure = sum(len(np.unique(feat_pt[tt.obs_cam[s:e], tt.obs_feat[s:e]])) == 1
               for s, e in zip(starts, ends))
    assert pure / tt.n_tracks > 0.97


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_conflicting_edge_is_rejected(impl):
    """Image 0's features 0 and 1 both reach image 1's feature 0 through
    image 2: the edge that would put two features of image 0 in one track
    is refused, the first-come track keeps its three observations."""
    pairs = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    idx = np.zeros((3, 4), np.int32)
    valid = np.zeros((3, 4), bool)
    idx[0, 0], valid[0, 0] = 0, True        # (0,0)-(1,0)
    idx[1, 0], valid[1, 0] = 3, True        # (1,0)-(2,3)
    idx[2, 1], valid[2, 1] = 3, True        # (0,1)-(2,3): conflicts with (0,0)
    tt = ttracks.build_tracks(pairs, idx, valid, 3, 4, impl=impl)
    ref = jtracks.build_tracks(pairs, idx, valid, 3, 4)
    assert canonical(tt) == canonical(ref) == [((0, 0), (1, 0), (2, 3))]


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_empty_and_bad_arguments(impl):
    e = ttracks.build_tracks(np.zeros((0, 2), np.int32), np.zeros((0, 8), np.int32),
                             np.zeros((0, 8), bool), 3, 8, impl=impl)
    assert e.n_tracks == 0 and len(e.obs_cam) == 0
    with pytest.raises(ValueError):
        ttracks.build_tracks(np.zeros((0, 2), np.int32), np.zeros((0, 8), np.int32),
                             np.zeros((0, 8), bool), 3, 8, impl="python")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to numpy."""
    bad = tmp_path / "tracks.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native_tracks, "SRC", bad)
    monkeypatch.setattr(_native_tracks, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native_tracks, "_LIB", [])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ttracks.build_tracks(np.array([[0, 1]], np.int32), np.zeros((1, 4), np.int32),
                             np.ones((1, 4), bool), 2, 4)
