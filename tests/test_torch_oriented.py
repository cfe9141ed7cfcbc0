"""Oriented extraction on the port (``features.detect(with_orientation)``,
``_orientation``, ``_bilinear``, ``describe``): the ``extractor_output``
cases of tests/test_features.py (a 25-degree rotated and shifted pair at
160x160, ``oriented=True``), the port's functions against ``sfmx``'s from
the same levels and keypoints, and the whole chain from the same images.

Tolerances: from the same inputs, angles within 1e-5 rad (mod 2 pi) and
descriptors within 1e-5 (the same bilinear samples and finite differences,
summed in another order), bit words equal but for comparisons within
rounding of a tie (>= 99.5 % of words).  The whole chain from the same
images differs in the scale space by F1 (the blur rounds differently, the
diffusion carries it to ~1e-5), which moves a few keypoints' NMS, top-K
order or subpixel fit: >= 90 % of the reference's valid keypoints have a
port keypoint within 0.01 px whose angle is within 1e-3 rad (measured
96 %), and those descriptors agree within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import features as jf
from sfmx_torch.kernels import features as tf
from sfmx_torch.kernels import matching
from tests.test_features import H, W, make_texture, warp_affine

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    img = make_texture(rng)
    theta = np.deg2rad(25.0)
    c, s = np.cos(theta), np.sin(theta)
    cx, cy = W / 2, H / 2
    M = np.array([[c, -s, cx - c * cx + s * cy + 6.0], [s, c, cy - s * cx - c * cy - 4.0]])
    return np.stack([img, warp_affine(img, M)]).astype(np.float32), M


@pytest.fixture(scope="module")
def extractor_output(pair):
    batch, M = pair
    feats = tf.detect_and_describe(T(batch), max_keypoints=200, threshold=1e-7,
                                   oriented=True)
    return batch[0], batch[1], M, feats


@pytest.fixture(scope="module")
def ref_stages(pair):
    batch = jnp.asarray(pair[0])
    cfg = jf.ScaleSpaceConfig()
    lv = jf.build_scale_space(batch, cfg)
    resp = jf.hessian_response(lv, cfg)
    kp = jf.detect(lv, resp, cfg, max_keypoints=200, threshold=1e-7, with_orientation=True)
    return lv, resp, kp


def test_detects_keypoints(extractor_output):
    _, _, _, feats = extractor_output
    assert int(feats.kp.mask[0].sum()) > 30 and int(feats.kp.mask[1].sum()) > 30
    assert not torch.isnan(feats.kp.uv).any() and not torch.isnan(feats.desc).any()
    assert feats.kp.angle[feats.kp.mask].abs().max() > 0.1  # not upright


def test_repeatability_under_warp(extractor_output):
    _, _, M, feats = extractor_output
    uv0 = feats.kp.uv[0][feats.kp.mask[0]].numpy()
    uv1 = feats.kp.uv[1][feats.kp.mask[1]].numpy()
    proj = np.hstack([uv0, np.ones((len(uv0), 1))]) @ M.T
    inside = (proj[:, 0] > 12) & (proj[:, 0] < W - 12) & (proj[:, 1] > 12) & (proj[:, 1] < H - 12)
    proj = proj[inside]
    d = np.linalg.norm(proj[:, None, :] - uv1[None, :, :], axis=2).min(axis=1)
    assert (d < 3.0).mean() > 0.5, f"repeatability {(d < 3.0).mean()}"


def test_descriptor_matching_under_warp(extractor_output):
    _, _, M, feats = extractor_output
    res = matching.match_float(feats.desc[0], feats.desc[1], feats.kp.mask[0],
                               feats.kp.mask[1], ratio=0.85)
    idx, valid = res.idx.numpy(), res.valid.numpy()
    uv0, uv1 = feats.kp.uv[0].numpy(), feats.kp.uv[1].numpy()
    proj = np.hstack([uv0, np.ones((len(uv0), 1))]) @ M.T
    err = np.linalg.norm(proj[valid] - uv1[idx[valid]], axis=1)
    assert valid.sum() >= 15
    assert (err < 4.0).mean() > 0.7, f"match precision {(err < 4.0).mean()}"


def test_binary_descriptor_matches_float_semantics(extractor_output):
    _, _, _, feats = extractor_output
    m = feats.kp.mask
    res = matching.match_hamming(feats.desc_bits[0], feats.desc_bits[1], m[0], m[1],
                                 ratio=0.85)
    res_f = matching.match_float(feats.desc[0], feats.desc[1], m[0], m[1], ratio=0.85)
    both = (res.valid & res_f.valid).numpy()
    assert both.sum() > 5
    assert (res.idx.numpy()[both] == res_f.idx.numpy()[both]).mean() > 0.8


def test_detect_orientation_matches_reference(ref_stages):
    """detect(with_orientation=True) from the reference's levels and
    responses: the same slots, angles within 1e-5 rad."""
    lv, resp, kp = ref_stages
    got = tf.detect(T(lv), T(resp), tf.ScaleSpaceConfig(), max_keypoints=200,
                    threshold=1e-7, with_orientation=True)
    assert torch.equal(got.mask, T(kp.mask))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(kp.uv))
    assert _angle_diff(got.angle.numpy(), np.asarray(kp.angle)).max() < 1e-5
    up = tf.detect(T(lv), T(resp), tf.ScaleSpaceConfig(), max_keypoints=200,
                   threshold=1e-7, with_orientation=False)
    assert torch.equal(up.angle, torch.zeros_like(up.angle))


@pytest.mark.parametrize("chunk", [None, 7 * 169 * 2])
def test_orientation_matches_reference(ref_stages, chunk, monkeypatch):
    """_orientation on the same levels and integer positions (and in
    gather chunks of 7 keypoints)."""
    lv, _, kp = ref_stages
    if chunk:
        monkeypatch.setattr(tf, "GATHER_SAMPLES", chunk)
    rng = np.random.default_rng(0)
    B, K = np.asarray(kp.level).shape
    iy = rng.integers(-5, H + 5, (B, K))         # the border clamp included
    ix = rng.integers(-5, W + 5, (B, K))
    lvl = np.asarray(kp.level)
    sigma = np.asarray(kp.sigma)
    want = np.asarray(jf._orientation(lv, jnp.asarray(lvl), jnp.asarray(iy, jnp.int32),
                                      jnp.asarray(ix, jnp.int32), jnp.asarray(sigma)))
    got = tf._orientation(T(lv), T(lvl).long(), T(iy), T(ix), T(sigma)).numpy()
    assert _angle_diff(got, want).max() < 1e-5


def test_bilinear_matches_reference(ref_stages):
    lv = np.asarray(ref_stages[0])
    rng = np.random.default_rng(1)
    x = rng.uniform(-3, W + 3, (2, 5, 50)).astype(np.float32)
    y = rng.uniform(-3, H + 3, (2, 5, 50)).astype(np.float32)
    lvl = rng.integers(0, lv.shape[1], (2, 5))
    want = np.stack([np.stack([np.asarray(jf._bilinear(jnp.asarray(lv[b, lvl[b, k]]),
                                                       jnp.asarray(x[b, k]),
                                                       jnp.asarray(y[b, k])))
                               for k in range(5)]) for b in range(2)])
    got = tf._bilinear(T(lv), T(lvl).long(), T(x), T(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_describe_matches_reference(ref_stages):
    """The oriented describe from the reference's levels and keypoints."""
    lv, _, kp = ref_stages
    want_f, want_b = jf.describe(lv, kp)
    tkp = tf.Keypoints(*(T(x) for x in kp))._replace(level=T(kp.level).long())
    got_f, got_b = tf.describe(T(lv), tkp)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    assert (got_b.numpy().view(np.uint32) == np.asarray(want_b)).mean() >= 0.995


def test_oriented_chain_matches_reference(pair):
    """The whole oriented extraction from the same images (2 octaves)."""
    batch = pair[0]
    want = jf.detect_and_describe(jnp.asarray(batch), max_keypoints=200, threshold=1e-7,
                                  oriented=True, n_octaves=2)
    got = tf.detect_and_describe(T(batch), max_keypoints=200, threshold=1e-7,
                                 oriented=True, n_octaves=2)
    for b in range(2):
        jm, tm = np.asarray(want.kp.mask[b]), got.kp.mask[b].numpy()
        ju, tu = np.asarray(want.kp.uv[b])[jm], got.kp.uv[b].numpy()[tm]
        d = np.linalg.norm(ju[:, None] - tu[None], axis=-1)
        j = d.argmin(1)
        ang = _angle_diff(np.asarray(want.kp.angle[b])[jm], got.kp.angle[b].numpy()[tm][j])
        good = (d.min(1) < 0.01) & (ang < 1e-3)
        assert good.mean() >= 0.9, good.mean()
        dd = np.abs(np.asarray(want.desc[b])[jm] - got.desc[b].numpy()[tm][j]).max(1)
        assert dd[good].max() < 1e-3
