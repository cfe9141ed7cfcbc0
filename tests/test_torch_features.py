"""sfmx_torch extraction parity: K1/K2/K3 plain versions against the
``sfmx`` jnp oracles and the Pallas kernels in interpret mode, and the whole
two-octave ``detect_and_describe`` — the same numpy inputs through both
packages.  The CUDA kernels' own checks are in test_torch_gpu.py."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import features as jf
from sfmx.kernels import pallas_describe as jpd
from sfmx.kernels import pallas_scale_space as jpss
from sfmx_torch.kernels import describe as tdsc
from sfmx_torch.kernels import features as tf
from sfmx_torch.kernels import scale_space as tss

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG3 = (2, 3, 4)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(4)
    return rng.random((2, 96, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_levels(images):
    cfg = jf.ScaleSpaceConfig(sigma_levels=CFG3)
    lv = jf.build_scale_space(jnp.asarray(images), cfg)
    return np.asarray(lv), np.asarray(jf.hessian_response(lv, cfg))


def _magnitudes(L0):
    """JAX's and the port's Scharr gradient magnitudes of the same L0, (B,N)."""
    jx, jy = jf.scharr_roll(jnp.asarray(L0))
    tx, ty = tf.scharr_roll(T(L0))
    return (np.asarray(jnp.sqrt(jx * jx + jy * jy)).reshape(len(L0), -1),
            torch.sqrt(tx * tx + ty * ty).numpy().reshape(len(L0), -1))


def test_scharr_magnitude_matches_reference(images):
    """The contrast's Scharr magnitudes on the same L0: atol 1e-8 (values
    up to ~0.12; the stencil sums in the same order, so only the last bit
    of the sqrt argument can differ)."""
    L0 = np.asarray(jf.gaussian_blur(jnp.asarray(images), 2.0))
    jmag, tmag = _magnitudes(L0)
    np.testing.assert_allclose(tmag, jmag, rtol=0, atol=1e-8)


def test_percentile_linear_matches_numpy(images):
    """The port's percentile on the SAME magnitudes against numpy's linear
    method: rtol 1e-6 (exact selection; only the f32 interpolation rounds)."""
    L0 = np.asarray(jf.gaussian_blur(jnp.asarray(images), 2.0))
    jmag, _ = _magnitudes(L0)
    for q in (70.0, 50.0, 99.9):
        out = tf._percentile_linear(T(jmag), q).numpy()
        np.testing.assert_allclose(out, np.percentile(jmag, q, axis=1, method="linear"),
                                   rtol=1e-6)


def test_blur_and_contrast_match_reference(images):
    """Zero-padded separable blur: atol 1e-6 (conv summation order differs
    from XLA's by at most 2 ulp).  contrast_k2 end to end within one
    order-statistic gap: k interpolates between two neighbouring order
    statistics of the 12,288 magnitudes, so a last-bit difference in a
    magnitude, or a selection a place or two over (seen once under a
    6-worker run: k^2 0.00057425 against 0.0005743, i.e. k two places
    down), moves k by about one gap.  The gap is the largest between
    neighbouring order statistics within 4 places of the 70th-percentile
    position (~1e-6..1e-5 here); k^2 may move by (k_port + k_ref) times it."""
    L0 = np.asarray(jf.gaussian_blur(jnp.asarray(images), 2.0))
    np.testing.assert_allclose(tf.gaussian_blur(T(images), 2.0).numpy(), L0, atol=1e-6)
    jmag, _ = _magnitudes(L0)
    srt = np.sort(jmag, axis=1)
    lo = int(np.floor(0.7 * (jmag.shape[1] - 1)))
    gap = np.max(np.diff(srt[:, lo - 4:lo + 6], axis=1), axis=1)     # (B,)
    k2_ref = np.asarray(jf.contrast_k2(jnp.asarray(L0)))[:, 0, 0]
    k2_out = tf.contrast_k2(T(L0)).numpy()[:, 0, 0]
    bound = (np.sqrt(k2_ref) + np.sqrt(k2_out)) * gap
    assert (np.abs(k2_out - k2_ref) <= bound).all(), (k2_out, k2_ref, bound)
    np.testing.assert_array_equal(tf.fed_tau_schedule(5.0), jf.fed_tau_schedule(5.0))
    np.testing.assert_array_equal(tf.gaussian_kernel1d(2.0), jf.gaussian_kernel1d(2.0))


def test_k1_plain_matches_reference_segments(images):
    """K1 plain vs _diffusion_step chains and the Pallas kernel (interpret),
    each segment from the same input: atol 1e-5 (test_features.py's)."""
    cfg = tf.ScaleSpaceConfig(sigma_levels=CFG3)
    L = np.asarray(jf.gaussian_blur(jnp.asarray(images), 2.0))
    k2 = np.asarray(jf.contrast_k2(jnp.asarray(L)))[:, 0, 0]
    for taus in tf.level_taus(cfg):
        ref = jnp.asarray(L)
        for tau in taus:
            ref = jf._diffusion_step(ref, jnp.asarray(k2)[:, None, None], tau)
        pal = jpss.diffuse_segment(jnp.asarray(L), jnp.asarray(k2), taus, interpret=True)
        out = tss.diffuse_segment(T(L), T(k2), taus).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(out, np.asarray(pal), atol=1e-5)
        L = np.asarray(ref)


def test_k2_plain_matches_reference(ref_levels):
    """K2 plain vs hessian_response and response_level (interpret): atol 1e-5."""
    lv, resp = ref_levels
    out = tss.response_levels(T(lv), CFG3).numpy()
    np.testing.assert_allclose(out, resp, atol=1e-5)
    for i, d in enumerate(CFG3):
        pal = jpss.response_level(jnp.asarray(lv[:, i]), d, interpret=True)
        np.testing.assert_allclose(out[:, i], np.asarray(pal), atol=1e-5)


def test_scale_space_chain_matches_reference(images, ref_levels):
    """Whole front end from images.  Levels: atol 5e-5 — the blur differs
    from XLA's conv by <=2e-7 and the Perona-Malik steps amplify it (F1 in
    ROADMAP.md, ~1.4e-5 here); responses atol 1e-6 (peak ~7e-3)."""
    lv, resp = ref_levels
    tl, tr = tss.build_scale_space_and_response(T(images), tf.ScaleSpaceConfig(CFG3))
    np.testing.assert_allclose(tl.numpy(), lv, atol=5e-5)
    np.testing.assert_allclose(tr.numpy(), resp, atol=1e-6)
    np.testing.assert_allclose(tf.build_scale_space(T(images), tf.ScaleSpaceConfig(CFG3)).numpy(),
                               tl.numpy(), atol=0)


def _describe_inputs(rng, B=2, L=3, H=96, W=150, K=24, edge=False):
    levels = rng.random((B, L, H, W)).astype(np.float32)
    lo, hi = (0.0, float(max(H, W))) if edge else (40.0, 80.0)
    uv = rng.uniform(lo, hi, (B, K, 2)).astype(np.float32)
    lvl = rng.integers(0, L, (B, K)).astype(np.int32)
    sigma = rng.choice([2.0, 3.0, 6.0, 12.0], (B, K)).astype(np.float32)
    mask = rng.random((B, K)) > 0.2
    return levels, uv, lvl, sigma, mask


@pytest.mark.parametrize("edge", [False, True])
def test_k3_plain_matches_reference(edge):
    """K3 plain vs describe_upright_reference on a level that needs zero
    padding (96x150 -> 256x256), keypoints inside and at the borders,
    masked rows included: atol 1e-5."""
    args = _describe_inputs(np.random.default_rng(3), edge=edge)
    ref = np.asarray(jpd.describe_upright_reference(*(jnp.asarray(a) for a in args)))
    out = tdsc.describe_upright(*(T(a) for a in args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert (out[~args[4]] == 0).all() and (out[..., 87:] == 0).all()


def test_k3_plain_matches_pallas_interpret():
    """K3 plain vs the Pallas kernel in interpret mode (interior keypoints,
    where its 256-window resample equals the clipped bilinear): atol 1e-5."""
    rng = np.random.default_rng(3)
    B, L, H, W, K = 1, 3, 160, 160, 16
    levels = rng.random((B, L, H, W)).astype(np.float32)
    uv = rng.uniform(40, 120, (B, K, 2)).astype(np.float32)
    lvl = rng.integers(0, L, (B, K)).astype(np.int32)
    sigma = rng.choice([2.0, 3.0], (B, K)).astype(np.float32)
    mask = np.ones((B, K), bool)
    args = (levels, uv, lvl, sigma, mask)
    pal = jpd.describe_upright(*(jnp.asarray(a) for a in args), interpret=True)
    out = tdsc.describe_upright(*(T(a) for a in args)).numpy()
    np.testing.assert_allclose(out, np.asarray(pal), atol=1e-5)


def test_finalize_bits_bit_exact_and_float():
    rng = np.random.default_rng(8)
    raw = np.zeros((3, 10, 128), np.float32)
    raw[..., :87] = rng.normal(size=(3, 10, 87))
    raw[0, 0, :87] = 0.5                               # all comparisons tie
    mask = rng.random((3, 10)) > 0.3
    ref_bits = np.asarray(jpd.finalize_bits(jnp.asarray(raw), jnp.asarray(mask)))
    out_bits = tdsc.finalize_bits(T(raw), T(mask)).numpy()
    assert out_bits.dtype == np.int32
    np.testing.assert_array_equal(out_bits.view(np.uint32), ref_bits)
    ref_f = np.asarray(jpd.finalize_float(jnp.asarray(raw), jnp.asarray(mask)))
    np.testing.assert_allclose(tdsc.finalize_float(T(raw), T(mask)).numpy(), ref_f, atol=1e-6)


def test_downsample_matches_reference():
    x = np.random.default_rng(1).random((2, 9, 13)).astype(np.float32)
    np.testing.assert_allclose(tf._downsample2(T(x)).numpy(),
                               np.asarray(jf._downsample2(jnp.asarray(x))), atol=1e-7)


def test_detect_and_describe_two_octaves_matches_reference():
    """Two rendered room frames (160x120), n_octaves=2, K=128, matched as
    sets: >= 98% of the reference's valid keypoints have a port keypoint
    within 0.05 px, and >= 98% of matched descriptors agree within atol 1e-4
    (all within 1e-3).  The remainder is F1 (ROADMAP.md): level differences
    of ~1e-5 from the blur's summation order, amplified by the per-group
    standardization of low-contrast cell groups."""
    from examples import room

    tex = room.RoomTexture(seed=0)
    imgs = np.stack([room.render_room(tex, R, eye, 160, 120, 140.0)
                     for R, _t, eye in room.walk_poses(6)[:2]])
    ref = jf.detect_and_describe(jnp.asarray(imgs), max_keypoints=128, threshold=1e-7,
                                 n_octaves=2)
    out = tf.detect_and_describe(T(imgs), max_keypoints=128, threshold=1e-7, n_octaves=2)
    n_ok = n_ref = n_desc = n_desc_ok = 0
    for b in range(2):
        rm = np.asarray(ref.kp.mask[b])
        om = out.kp.mask[b].numpy()
        ruv = np.asarray(ref.kp.uv[b])[rm]
        ouv = out.kp.uv[b].numpy()[om]
        d = np.linalg.norm(ruv[:, None] - ouv[None], axis=-1)
        j = d.argmin(axis=1)
        close = d[np.arange(len(ruv)), j] < 0.05
        n_ok += int(close.sum())
        n_ref += len(ruv)
        rdesc = np.asarray(ref.desc[b])[rm][close]
        odesc = out.desc[b].numpy()[om][j[close]]
        err = np.abs(odesc - rdesc).max(axis=1)
        n_desc += len(err)
        n_desc_ok += int((err <= 1e-4).sum())
        assert err.max() <= 1e-3, err.max()
    assert n_ref > 100 and n_ok >= 0.98 * n_ref, (n_ok, n_ref)
    assert n_desc_ok >= 0.98 * n_desc, (n_desc_ok, n_desc)


def test_wrappers_never_fall_back_off_cpu():
    """A non-CPU tensor that is not on a card makes each wrapper raise:
    the plain version runs for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        tss.diffuse_segment(torch.zeros(1, 8, 8, device=meta), torch.ones(1, device=meta), (0.1,))
    with pytest.raises(ValueError):
        tss.response_levels(torch.zeros(1, 2, 8, 8, device=meta), (2, 3))
    with pytest.raises(ValueError):
        tdsc.describe_upright(torch.zeros(1, 1, 8, 8, device=meta),
                              torch.zeros(1, 2, 2, device=meta),
                              torch.zeros(1, 2, dtype=torch.int32, device=meta),
                              torch.ones(1, 2, device=meta),
                              torch.ones(1, 2, dtype=torch.bool, device=meta))
