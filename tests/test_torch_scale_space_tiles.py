"""K1's tiling on the CPU: the plain-PyTorch mirror of the kernel's
decomposition (``scale_space.diffuse_segment_tiled``: launches of at most
``MAX_FUSED`` FED steps, tiles of ``TILE_H x TILE_W`` loaded with a halo of
2 pixels per fused step through wrapped indices) against the plain version,
and the plain version against ``sfmx.kernels.features`` on the same numpy
inputs.

Tolerances, and why:
- tiled against plain: bit-equal.  Both run the same elementwise f32
  arithmetic on the same values; the tiling only changes where a value is
  computed, and the spoiled border of a padded tile never reaches the part
  that is kept.
- plain against the reference's ``_diffusion_step`` chain: atol 1e-5, the
  tolerance ``tests/test_torch_features.py`` states (XLA fuses multiply-adds
  where PyTorch's CPU kernels do not; levels lie in [0, 1]).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import features as jf
from sfmx_torch.kernels import features as tf
from sfmx_torch.kernels import scale_space as tss

torch.set_num_threads(2)
CFG = tf.ScaleSpaceConfig()
KERNEL_TILE = (tss.TILE_H, tss.TILE_W)

# (id, image batch shape, tile): the kernel's own tile unless the case is
# about a tile count the small images cannot reach with it
CASES = [
    ("odd-97x131", (2, 97, 131), KERNEL_TILE),            # no tile multiple, two tiles each way
    ("120x160", (3, 120, 160), KERNEL_TILE),
    ("smaller-than-a-tile", (2, 40, 56), KERNEL_TILE),    # one clipped tile, the halo wraps
    ("halo-wraps-twice", (1, 6, 7), KERNEL_TILE),         # side < halo: several turns round
    ("one-exact-tile", (1, tss.TILE_H, tss.TILE_W), KERNEL_TILE),
    ("many-small-tiles", (2, 50, 70), (16, 24)),          # 4 x 3 tiles, ragged last ones
    ("tile-of-one-row", (1, 9, 33), (1, 32)),
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    L = np.array(jf.gaussian_blur(jnp.asarray(rng.random(shape).astype(np.float32)), 2.0))
    k2 = np.array(jf.contrast_k2(jnp.asarray(L)))[:, 0, 0]
    return L, k2


@pytest.mark.parametrize("seg", range(CFG.n_levels - 1))
@pytest.mark.parametrize("name,shape,tile", CASES, ids=[c[0] for c in CASES])
def test_k1_tiling_is_bit_equal_to_plain(name, shape, tile, seg):
    """Every segment of the default config (5, 6, 7, 8 FED steps) through
    the tiled mirror equals ``diffuse_segment_plain`` bit for bit, and the
    plain version agrees with the reference's step chain (atol 1e-5)."""
    taus = tf.level_taus(CFG)[seg]
    L, k2 = _inputs(shape, seed=seg)
    plain = tss.diffuse_segment_plain(torch.from_numpy(L), torch.from_numpy(k2), taus)
    tiled = tss.diffuse_segment_tiled(torch.from_numpy(L), torch.from_numpy(k2), taus, tile)
    assert torch.equal(tiled, plain)
    ref = jnp.asarray(L)
    for tau in taus:
        ref = jf._diffusion_step(ref, jnp.asarray(k2)[:, None, None], tau)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n", range(0, 17))
def test_fused_chunks_cover_the_segment_in_order(n):
    """The launches of a segment: the fewest of at most MAX_FUSED steps, as
    even as possible, every step once and in order; each fits the block's
    shared memory on the kernel's tile."""
    taus = tuple(float(i) for i in range(n))
    chunks = tss.fused_chunks(taus)
    assert sum(chunks, ()) == taus
    assert len(chunks) == -(-n // tss.MAX_FUSED)
    if chunks:
        sizes = [len(c) for c in chunks]
        assert max(sizes) <= tss.MAX_FUSED and max(sizes) - min(sizes) <= 1
        assert tss._plane_bytes(max(sizes), *KERNEL_TILE) <= tss.SMEM_BYTES


def _fma32(a, b, c):
    """f32 fused multiply-add: the product of two f32 is exact in f64 and the
    sum rounds once to f64 before f32 (a double rounding that is too rare to
    show in these samples)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("seed_ulp", [-1, 0, 1])
def test_written_out_division_rounds_like_ieee(seed_ulp):
    """The K1 kernel writes its two divisions out (``scale_space.cu``,
    ``conductance_of`` and ``rcp_rn_normal``): r = fma(r0, fma(-x, r0, 1), r0)
    from an approximate reciprocal r0, and q = fma(r, fma(-k2, s*r, s), s*r).
    Emulated in numpy on 200,000 operands of the kernel's range, with the
    seed r0 moved by ``seed_ulp`` ulps off the rounded reciprocal (the
    hardware's is within one): the same bits as ``1/x`` and ``s/k2``."""
    rng = np.random.default_rng(10 + seed_ulp)
    one = np.float32(1)

    def rcp(x):
        r0 = one / x
        if seed_ulp:
            r0 = np.nextafter(r0, np.float32(np.inf * seed_ulp))
        return _fma32(r0, _fma32(-x, r0, np.ones_like(x)), r0)

    d = (1 + np.exp(rng.uniform(np.log(1e-9), np.log(1e6), 200000))).astype(np.float32)
    np.testing.assert_array_equal(rcp(d), one / d)
    k2 = np.exp(rng.uniform(np.log(1e-6), np.log(1.0), 200000)).astype(np.float32)
    s = np.exp(rng.uniform(np.log(1e-12), np.log(2.0), 200000)).astype(np.float32)
    rk = rcp(k2)
    q0 = s * rk
    np.testing.assert_array_equal(_fma32(rk, _fma32(-k2, q0, s), q0), s / k2)


def test_default_segments_fit_and_count():
    """The default config's segments have 5, 6, 7, 8 steps; the wrapper's
    CPU route is the plain version (the tiled mirror is for tests only)."""
    segs = tf.level_taus(CFG)
    assert [len(t) for t in segs] == [5, 6, 7, 8]
    L, k2 = _inputs((1, 24, 32), seed=9)
    out = tss.diffuse_segment(torch.from_numpy(L), torch.from_numpy(k2), segs[0])
    assert torch.equal(out, tss.diffuse_segment_plain(torch.from_numpy(L), torch.from_numpy(k2),
                                                      segs[0]))
