"""K2's tiling on the CPU: the plain-PyTorch mirror of the kernel's
decomposition (``scale_space.response_levels_tiled``: per level of aperture
d, tiles of ``RESP_TILE_H x RESP_TILE_W`` loaded with a halo of 2 d through
wrapped indices, Scharr twice on the padded tile, the interior kept) against
the plain version, and the plain version against ``sfmx.kernels.features`` on
the same numpy inputs.

Tolerances, and why:
- tiled against plain: bit-equal.  Both run the same elementwise f32
  arithmetic on the same values; the tiling only changes where a value is
  computed, and the border that each Scharr pass spoils on a padded tile
  (d pixels) never reaches the part that is kept.
- plain against the reference's ``hessian_response``: atol 1e-6, the
  tolerance ``chip_smoke.py`` states for K2 (responses peak near 1e-2; XLA
  fuses multiply-adds where PyTorch's CPU kernels do not).
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
KERNEL_TILE = (tss.RESP_TILE_H, tss.RESP_TILE_W)

# (id, stack shape (B, H, W), tile): the kernel's own tile unless the case is
# about a tile count the small images cannot reach with it
CASES = [
    ("vga-480x640", (1, 480, 640), KERNEL_TILE),             # 10 x 5 tiles, all whole
    ("odd-97x131", (2, 97, 131), KERNEL_TILE),               # no tile multiple, ragged both ways
    ("smaller-than-the-halo-10x14", (2, 10, 14), KERNEL_TILE),   # 2 d = 12 > H: several turns round
    ("one-exact-tile", (1, tss.RESP_TILE_H, tss.RESP_TILE_W), KERNEL_TILE),
    ("many-small-tiles", (2, 50, 70), (16, 24)),             # 4 x 3 tiles, ragged last ones
    ("tile-of-one-row", (1, 9, 33), (1, 32)),
    ("half-size-octave-120x160", (3, 120, 160), KERNEL_TILE),
]


def _levels(shape, seed):
    """A (B, L, H, W) stack of smooth levels in [0, 1]: blurred noise, each
    level blurred a little more, as a scale space is."""
    rng = np.random.default_rng(seed)
    B, H, W = shape
    base = jnp.asarray(rng.random((B, H, W)).astype(np.float32))
    return np.stack([np.array(jf.gaussian_blur(base, float(s))) for s in CFG.sigma_levels], axis=1)


@pytest.mark.parametrize("name,shape,tile", CASES, ids=[c[0] for c in CASES])
def test_k2_tiling_is_bit_equal_to_plain(name, shape, tile):
    """All five apertures (2..6) through the tiled mirror equal
    ``response_levels_plain`` bit for bit, and the plain version agrees with
    the reference's ``hessian_response`` (atol 1e-6)."""
    levels = _levels(shape, seed=len(name))
    plain = tss.response_levels_plain(torch.from_numpy(levels), CFG.sigma_levels)
    tiled = tss.response_levels_tiled(torch.from_numpy(levels), CFG.sigma_levels, tile)
    assert torch.equal(tiled, plain)
    ref = jf.hessian_response(jnp.asarray(levels), jf.ScaleSpaceConfig(tuple(CFG.sigma_levels)))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=1e-6)
    assert float(plain.abs().max()) > 1e-5            # the comparison is not of zeros


@pytest.mark.parametrize("sigmas", [(1,), (2, 9), (7, 3, 1)])
def test_k2_tiling_other_apertures(sigmas):
    """Apertures other than the default's, in any order, on a size that is no
    tile multiple: still bit-equal (the halo follows each level's own d)."""
    rng = np.random.default_rng(sum(sigmas))
    levels = torch.from_numpy(rng.random((2, len(sigmas), 45, 61)).astype(np.float32))
    assert torch.equal(tss.response_levels_tiled(levels, sigmas, (16, 32)),
                       tss.response_levels_plain(levels, sigmas))


def test_k2_tile_fits_the_block():
    """The kernel's tile at the default config's largest aperture fits the
    227 KB a block may use and the widest plane row the loader takes; the
    wrapper's CPU route is the plain version (the mirror is for tests only)."""
    d = max(CFG.sigma_levels)
    assert tss._response_bytes(d, *KERNEL_TILE) <= tss.SMEM_BYTES
    assert tss.RESP_TILE_W + 4 * d <= tss.MAX_PLANE_W
    assert tss.RESP_THREADS % 32 == 0 and 32 <= tss.RESP_THREADS <= 1024
    levels = torch.from_numpy(_levels((1, 24, 32), seed=3))
    assert torch.equal(tss.response_levels(levels, CFG.sigma_levels),
                       tss.response_levels_plain(levels, CFG.sigma_levels))
