"""sfmx_torch CUDA kernels K1-K3 against their plain PyTorch versions.

These need a card and skip without one.  The file imports neither jax nor
sfmx, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

from sfmx_torch.kernels import _build
from sfmx_torch.kernels import describe as dsc
from sfmx_torch.kernels import features as F
from sfmx_torch.kernels import scale_space as ss

torch.set_num_threads(2)
CFG = F.ScaleSpaceConfig()


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(dev, B=3, H=120, W=160):
    g = torch.Generator().manual_seed(0)
    return torch.rand((B, H, W), generator=g).to(dev)


@pytest.mark.parametrize("shape", [(3, 120, 160), (2, 97, 131)])
def test_k1_diffuse_segment_matches_plain(cuda, shape):
    """Every FED segment, odd sizes included: atol 1e-4 (FMA contraction in
    the kernel; levels lie in [0,1]); one launch counted per FED step."""
    L = F.gaussian_blur(_images(cuda, *shape), 2.0).contiguous()
    k2 = F.contrast_k2(L).reshape(-1).contiguous()
    for taus in F.level_taus(CFG):
        before = _build.LAUNCHES.get("diffuse_segment")
        out = ss.diffuse_segment(L, k2, taus)
        assert _build.LAUNCHES.get("diffuse_segment") == before + len(taus)
        ref = ss.diffuse_segment_plain(L, k2, taus)
        assert float((out - ref).abs().max()) <= 1e-4
        L = ref


def test_k2_response_levels_matches_plain(cuda):
    """All five apertures in one call of two launches: atol 1e-6 (responses
    peak near 1e-2)."""
    levels, _ = ss.build_scale_space_and_response(_images(cuda), CFG)
    before = _build.LAUNCHES.get("response_levels")
    out = ss.response_levels(levels, CFG.sigma_levels)
    assert _build.LAUNCHES.get("response_levels") == before + 2
    ref = ss.response_levels_plain(levels, CFG.sigma_levels)
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("edge", [False, True])
def test_k3_describe_upright_matches_plain(cuda, edge):
    """Interior and border keypoints on a zero-padded level, masked rows:
    atol 1e-5; masked rows and columns 87..127 exactly zero."""
    rng = np.random.default_rng(3)
    B, L, H, W, K = 2, 5, 96, 150, 64
    lo, hi = (0.0, 160.0) if edge else (30.0, 90.0)
    levels = torch.as_tensor(rng.random((B, L, H, W)), dtype=torch.float32, device=cuda)
    uv = torch.as_tensor(rng.uniform(lo, hi, (B, K, 2)), dtype=torch.float32, device=cuda)
    lvl = torch.as_tensor(rng.integers(0, L, (B, K)), device=cuda)
    sigma = torch.as_tensor(rng.choice([2.0, 3.0, 6.0, 12.0], (B, K)), dtype=torch.float32,
                            device=cuda)
    mask = torch.as_tensor(rng.random((B, K)) > 0.2, device=cuda)
    out = dsc.describe_upright(levels, uv, lvl, sigma, mask)
    ref = dsc.describe_upright_reference(levels, uv, lvl, sigma, mask)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    assert bool((out[~mask] == 0).all()) and bool((out[..., 87:] == 0).all())


def test_extraction_on_card_matches_plain_path(cuda):
    """detect_and_describe through the kernels vs the same on the CPU
    (plain versions): keypoints within 0.05 px for >= 98% of the valid set."""
    imgs = _images(torch.device("cpu"), B=2)
    gpu = F.detect_and_describe(imgs.to(cuda), max_keypoints=128, threshold=1e-7, n_octaves=2)
    cpu = F.detect_and_describe(imgs, max_keypoints=128, threshold=1e-7, n_octaves=2)
    n_ok = n = 0
    for b in range(2):
        a = cpu.kp.uv[b][cpu.kp.mask[b]].numpy()
        g = gpu.kp.uv[b][gpu.kp.mask[b]].cpu().numpy()
        d = np.linalg.norm(a[:, None] - g[None], axis=-1).min(axis=1)
        n_ok += int((d < 0.05).sum())
        n += len(a)
    assert n > 50 and n_ok >= 0.98 * n


def test_wrappers_reject_bad_inputs(cuda):
    """Wrong dtype or a non-contiguous plane raises; nothing falls back."""
    L = torch.zeros(1, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        ss.diffuse_segment(L.double(), torch.ones(1, device=cuda), (0.1,))
    with pytest.raises(ValueError):
        ss.diffuse_segment(L.transpose(1, 2)[:, :8], torch.ones(1, device=cuda), (0.1,))
    with pytest.raises(ValueError):
        ss.response_levels(torch.zeros(1, 2, 16, 16, device=cuda), (2, 3, 4))
