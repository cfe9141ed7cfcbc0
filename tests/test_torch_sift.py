"""The SIFT-family extractor on the port (``sfmx_torch.kernels.sift``),
mirroring tests/test_sift.py's five cases, plus module parity with
``sfmx.kernels.sift`` from the same inputs.

Tolerances: the Gaussian pyramid and DoG within 1e-6 (the port's blur
rounds by at most 2 ulp against XLA's: F1), the edge mask equal but for
pixels whose trace^2/det lies within rounding of the ratio (>= 99.99 %),
detection from the reference's pyramid slot for slot (uv exact, masks
equal), descriptors from the reference's levels and keypoints within 1e-5
(the same samples, binned and summed in another order), the sign bits equal
from the same descriptors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.room import RoomTexture, render_room, walk_poses
from sfmx.kernels import sift as jsift
from sfmx_torch.cli.config import load_config
from sfmx_torch.cli.pipeline import extract_features
from sfmx_torch.kernels import features as tf
from sfmx_torch.kernels import matching, sift

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def views():
    tex = RoomTexture(seed=3)
    poses = walk_poses(10)  # adjacent frames -> small-baseline pairs
    return np.stack([render_room(tex, R, eye, 320, 240, 280.0)
                     for (R, t, eye) in poses[:6]]).astype(np.float32)


def test_sift_detects_stable_keypoints(views):
    f = sift.detect_and_describe_sift(T(views[:1]), max_keypoints=256)
    n = int(f.kp.mask.sum())
    assert n > 50, f"too few SIFT keypoints: {n}"
    d = f.desc[f.kp.mask].numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
    assert np.isfinite(d).all()


def test_sift_two_view_matching(views):
    f = sift.detect_and_describe_sift(T(views[:2]), max_keypoints=384)
    m = matching.match_float(f.desc[0], f.desc[1], f.kp.mask[0], f.kp.mask[1], ratio=0.9)
    valid = m.valid.numpy()
    n = int(valid.sum())
    assert n > 30, f"too few SIFT two-view matches: {n}"
    # matched keypoints displace coherently (the walk is a small motion)
    disp = f.kp.uv[1].numpy()[m.idx.numpy()[valid]] - f.kp.uv[0].numpy()[valid]
    inl = np.linalg.norm(disp - np.median(disp, axis=0), axis=1) < 30.0
    assert inl.mean() > 0.5, f"incoherent SIFT matches ({inl.mean():.2f})"


def test_pipeline_extractor_selection(views):
    cfg = load_config(overrides=["features.extractor=sift", "features.max_keypoints=256"])
    f = extract_features(views[:1], cfg, "cpu")
    assert int(f.kp.mask.sum()) > 30
    assert f.desc_bits.shape[-1] == tf.N_WORDS
    cfg2 = load_config(overrides=["features.max_keypoints=256"])
    f2 = extract_features(views[:1], cfg2, "cpu")
    assert int(f2.kp.mask.sum()) > 30


def test_sift_full_reconstruction(views):
    """End-to-end incremental SfM with the SIFT extractor."""
    from sfmx_torch.cli.pipeline import build_map

    cfg = load_config(overrides=["features.extractor=sift", "features.max_keypoints=384",
                                 "match.ratio=0.9"])
    intr = np.asarray([[280.0, 280.0, 160.0, 120.0, 0, 0, 0]], np.float32)
    scene, feats, tt, stats = build_map(views, intr, np.zeros(len(views), np.int32), cfg,
                                        "cpu", generator=torch.Generator().manual_seed(0))
    assert stats["n_registered"] >= 5, stats
    assert stats["n_points"] > 50, stats


def test_sift_multi_octave_scale_invariance():
    """The octave path keeps matching across a ~4.4x scale change."""
    from PIL import Image as PILImage

    rng = np.random.default_rng(5)
    img = rng.random((240, 320)).astype(np.float32)
    img = tf.gaussian_blur(T(img)[None], 3.0)[0].numpy()
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    small = np.asarray(PILImage.fromarray((img * 255).astype(np.uint8)).resize(
        (72, 54), PILImage.BILINEAR), np.float32) / 255.0
    scale = 320.0 / 72.0
    f1 = sift.detect_and_describe_sift(T(img)[None], max_keypoints=512, n_octaves=3)
    f2 = sift.detect_and_describe_sift(T(small)[None], max_keypoints=512)
    res = matching.match_pairs_float(torch.cat([f1.desc, f2.desc]),
                                     torch.cat([f1.kp.mask, f2.kp.mask]),
                                     np.asarray([[0, 1]], np.int32))
    idx, val = res.idx[0].numpy(), res.valid[0].numpy()
    err = np.linalg.norm(f1.kp.uv[0].numpy() / scale - f2.kp.uv[0].numpy()[idx], axis=1)
    n_good = int((val & (err < 3.0)).sum())
    assert n_good >= 8, n_good


@pytest.fixture(scope="module")
def ref_pyramid(views):
    G, dog = jsift.build_dog(jnp.asarray(views[:2]))
    return G, dog


def test_pyramid_and_edge_mask_match_reference(views, ref_pyramid):
    G, dog = ref_pyramid
    tG, tdog = sift.build_dog(T(views[:2]))
    np.testing.assert_allclose(tG.numpy(), np.asarray(G), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdog.numpy(), np.asarray(dog), rtol=0, atol=1e-6)
    same = sift._edge_mask(T(dog)).numpy() == np.asarray(jsift._edge_mask(dog))
    assert same.mean() >= 0.9999
    assert sift._dog_scales() == jsift._dog_scales()
    np.testing.assert_array_equal(sift._W_SPATIAL, jsift._W_SPATIAL)


@pytest.mark.parametrize("oriented", [False, True])
def test_detect_and_describe_match_reference(ref_pyramid, oriented):
    """detect on the reference's |DoG| and describe_sift / _binarize on its
    levels and keypoints."""
    G, dog = ref_pyramid
    resp = jnp.where(jsift._edge_mask(dog), jnp.abs(dog), 0.0)
    kp = jsift.detect(G[:, :-1], resp, jsift._dog_scales(), max_keypoints=256,
                      threshold=0.015, with_orientation=False)
    if oriented:
        kp = kp._replace(angle=jsift._orientation(
            G[:, :-1], kp.level, jnp.round(kp.uv[..., 1]).astype(jnp.int32),
            jnp.round(kp.uv[..., 0]).astype(jnp.int32), kp.sigma))
    got = tf.detect(T(G)[:, :-1], T(resp), sift._dog_scales(), max_keypoints=256,
                    threshold=0.015, with_orientation=False)
    assert torch.equal(got.mask, T(kp.mask))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(kp.uv))
    tkp = tf.Keypoints(*(T(x) for x in kp))._replace(level=T(kp.level).long())
    want = jsift.describe_sift(G, kp)
    desc = sift.describe_sift(T(G), tkp)
    np.testing.assert_allclose(desc.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    bits = sift._binarize(T(want), T(kp.mask))
    assert np.array_equal(bits.numpy().view(np.uint32), np.asarray(jsift._binarize(want, kp.mask)))


def test_sift_chain_matches_reference(views):
    """The whole extraction from the same images, 2 octaves: the valid
    keypoints agree (>= 95 % within 0.01 px), their descriptors within 1e-3."""
    want = jsift.detect_and_describe_sift(jnp.asarray(views[:2]), max_keypoints=256,
                                          n_octaves=2)
    got = sift.detect_and_describe_sift(T(views[:2]), max_keypoints=256, n_octaves=2)
    assert got.desc_bits.shape == want.desc_bits.shape
    for b in range(2):
        jm, tm = np.asarray(want.kp.mask[b]), got.kp.mask[b].numpy()
        d = np.linalg.norm(np.asarray(want.kp.uv[b])[jm][:, None]
                           - got.kp.uv[b].numpy()[tm][None], axis=-1)
        good = d.min(1) < 0.01
        assert good.mean() >= 0.95, good.mean()
        dd = np.abs(np.asarray(want.desc[b])[jm] - got.desc[b].numpy()[tm][d.argmin(1)]).max(1)
        assert dd[good].max() < 1e-3
