"""K3's pooling order on the CPU: ``describe.describe_upright_columns``
(per-column band sums, rows in order, then a cell's columns in order over
its area: the order of ``sfmx_torch/csrc/describe.cu``) against the port's
plain version and against ``sfmx.kernels.pallas_describe`` (its jnp oracle
and its Pallas kernel in interpret mode), on the same numpy inputs.

Tolerances: atol 1e-6 against the plain version (the same samples, only the
order of the cell sums differs: cell means of values in [0, 1] and of
gradients in [-1, 1]); atol 1e-5 against the reference, as
``test_torch_features.py`` holds the plain version to it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import pallas_describe as jpd
from sfmx_torch.kernels import describe as tdsc

torch.set_num_threads(2)


def _inputs(rng, B=2, L=3, H=96, W=150, K=24, edge=False, sigmas=(2.0, 3.0, 6.0, 12.0)):
    levels = rng.random((B, L, H, W)).astype(np.float32)
    lo, hi = (-2.0, float(max(H, W)) + 8.0) if edge else (40.0, 80.0)
    uv = rng.uniform(lo, hi, (B, K, 2)).astype(np.float32)
    lvl = rng.integers(0, L, (B, K)).astype(np.int32)
    sigma = rng.choice(np.asarray(sigmas, np.float32), (B, K))
    mask = rng.random((B, K)) > 0.2
    return levels, uv, lvl, sigma, mask


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("sigmas", [(2.0, 3.0, 6.0, 12.0), (1.6, 1.1, 24.0)])
def test_columns_match_plain_and_reference(edge, sigmas):
    """Interior and border keypoints on a level that needs zero padding
    (96x150 -> 256x256), sample spacing below and above one pixel, masked
    rows: the column order within 1e-6 of the plain version and 1e-5 of the
    reference's oracle; masked rows and columns 87..127 exactly zero."""
    args = _inputs(np.random.default_rng(5), edge=edge, sigmas=sigmas)
    targs = [torch.from_numpy(a) for a in args]
    cols = tdsc.describe_upright_columns(*targs).numpy()
    plain = tdsc.describe_upright_reference(*targs).numpy()
    np.testing.assert_allclose(cols, plain, atol=1e-6, rtol=0)
    ref = np.asarray(jpd.describe_upright_reference(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(cols, ref, atol=1e-5, rtol=0)
    assert (cols[~args[4]] == 0).all() and (cols[..., 87:] == 0).all()
    assert np.abs(cols[args[4]][:, :87]).max() > 0.1


def test_columns_match_pallas_interpret():
    """Against the Pallas kernel in interpret mode (interior keypoints, where
    its 256-window resample equals the clipped bilinear): atol 1e-5."""
    rng = np.random.default_rng(6)
    B, L, H, W, K = 1, 3, 160, 160, 16
    levels = rng.random((B, L, H, W)).astype(np.float32)
    uv = rng.uniform(40, 120, (B, K, 2)).astype(np.float32)
    lvl = rng.integers(0, L, (B, K)).astype(np.int32)
    sigma = rng.choice([2.0, 3.0], (B, K)).astype(np.float32)
    mask = np.ones((B, K), bool)
    args = (levels, uv, lvl, sigma, mask)
    pal = np.asarray(jpd.describe_upright(*(jnp.asarray(a) for a in args), interpret=True))
    cols = tdsc.describe_upright_columns(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(cols, pal, atol=1e-5, rtol=0)


def test_columns_all_masked_and_empty():
    """A batch with every row masked is all zeros; no keypoints gives (B,0,128)."""
    levels, uv, lvl, sigma, mask = _inputs(np.random.default_rng(7), K=8)
    out = tdsc.describe_upright_columns(*(torch.from_numpy(a) for a in
                                          (levels, uv, lvl, sigma, np.zeros_like(mask))))
    assert out.shape == (2, 8, 128) and bool((out == 0).all())
    empty = tdsc.describe_upright_columns(*(torch.from_numpy(a) for a in
                                            (levels, uv[:, :0], lvl[:, :0], sigma[:, :0],
                                             mask[:, :0])))
    assert empty.shape == (2, 0, 128)
