"""sfmx_torch CUDA kernels K1-K10 against their plain PyTorch versions.

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
from sfmx_torch.kernels import match as mt
from sfmx_torch.kernels import matching as mm
from sfmx_torch.kernels import pairs as mp
from sfmx_torch.kernels import scale_space as ss
from sfmx_torch.kernels import segsum as sg
from sfmx_torch.kernels import tiles as mtl
from sfmx_torch.solvers import lm, schur
from tests.smoke_scenes import ba_problem, pair_near_ties

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


# two tiles each way and no tile multiple; one exact tile; several tiles with
# a ragged last one; an image smaller than the halo (the load wraps twice)
K1_SHAPES = [(3, 120, 160), (2, 97, 131), (1, ss.TILE_H, ss.TILE_W), (2, 200, 300), (2, 6, 7)]


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_diffuse_segment_matches_plain(cuda, shape):
    """Every FED segment, odd sizes included: atol 1e-4 (FMA contraction in
    the kernel; levels lie in [0,1]); one launch counted per chunk of fused
    FED steps."""
    L = F.gaussian_blur(_images(cuda, *shape), 2.0).contiguous()
    k2 = F.contrast_k2(L).reshape(-1).contiguous()
    for taus in F.level_taus(CFG):
        before = _build.LAUNCHES.get("diffuse_segment")
        out = ss.diffuse_segment(L, k2, taus)
        torch.cuda.synchronize()
        assert _build.LAUNCHES.get("diffuse_segment") == before + len(ss.fused_chunks(taus))
        ref = ss.diffuse_segment_plain(L, k2, taus)
        assert float((out - ref).abs().max()) <= 1e-4
        L = ref


def test_k1_any_contrast_parameter(cuda):
    """k2 inside the range where the kernel writes its divisions out (the
    pipeline's k2 is >= 1e-6) and outside it, where it keeps the plain
    expression, image by image: atol 1e-4 against the plain version, and
    the same bits from a second launch."""
    L = F.gaussian_blur(_images(cuda, 5, 90, 170), 2.0).contiguous()
    k2 = torch.tensor([5e-4, 1e-14, 1e13, 1.0, 3e-38], device=cuda)
    taus = F.level_taus(CFG)[1]
    out = ss.diffuse_segment(L, k2, taus)
    ref = ss.diffuse_segment_plain(L, k2, taus)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-4
    assert torch.equal(out, ss.diffuse_segment(L, k2, taus))


@pytest.mark.parametrize("tile,n", [((96, 128), 7), ((120, 128), 3), ((16, 24), 8), ((1, 32), 1),
                                    ((130, 100), 1)])
def test_k1_one_launch_on_other_tiles(cuda, tile, n):
    """The kernel takes its tile and its fused step count at run time (the
    wrapper's constants are one choice): other choices that fit the block's
    shared memory give the same levels (atol 1e-4), one that does not fit
    raises."""
    L = F.gaussian_blur(_images(cuda, 2, 150, 210), 2.0).contiguous()
    k2 = F.contrast_k2(L).reshape(-1).contiguous()
    taus = F.level_taus(CFG)[3][:n]
    out = ss._diffuse_fused(L, k2, taus, *tile)
    torch.cuda.synchronize()
    assert float((out - ss.diffuse_segment_plain(L, k2, taus)).abs().max()) <= 1e-4
    with pytest.raises(ValueError):
        ss._diffuse_fused(L, k2, F.level_taus(CFG)[3], 120, 160)


# two tiles each way; no tile multiple; an image smaller than the halo of the
# largest aperture (the load wraps several times); several ragged tiles
K2_SHAPES = [(3, 120, 160), (2, 97, 131), (2, 10, 14), (1, 200, 300)]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_response_levels_matches_plain(cuda, shape):
    """All five apertures in one call of one launch, small and ragged sizes
    included: atol 1e-6 (responses peak near 1e-2)."""
    levels, _ = ss.build_scale_space_and_response(_images(cuda, *shape), CFG)
    before = _build.LAUNCHES.get("response_levels")
    out = ss.response_levels(levels, CFG.sigma_levels)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("response_levels") == before + 1
    ref = ss.response_levels_plain(levels, CFG.sigma_levels)
    assert float((out - ref).abs().max()) <= 1e-6
    assert float(ref.abs().max()) > 1e-5


@pytest.mark.parametrize("tile,threads", [((32, 128), 512), ((16, 24), 64), ((1, 32), 32),
                                          ((130, 100), 1024)])
def test_k2_one_launch_on_other_tiles(cuda, tile, threads):
    """The kernel takes its tile and its threads at run time (the wrapper's
    constants are one choice): other choices that fit the block's shared
    memory give the same response (atol 1e-6), one that does not fit raises."""
    levels, _ = ss.build_scale_space_and_response(_images(cuda, 2, 150, 210), CFG)
    out = ss._response_fused(levels, CFG.sigma_levels, *tile, threads)
    torch.cuda.synchronize()
    assert float((out - ss.response_levels_plain(levels, CFG.sigma_levels)).abs().max()) <= 1e-6
    with pytest.raises(ValueError):
        ss._response_fused(levels, CFG.sigma_levels, 200, 160, 256)


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


@pytest.mark.parametrize("K,kpb", [(61, 8), (37, 16), (5, 1), (29, 6)])
def test_k3_ragged_blocks_and_wide_sigmas(cuda, K, kpb):
    """K not a multiple of the keypoints a block takes, sigma from 1.6 to 24
    (sample spacing 1.39 to 20.9 px, so below and above one pixel), edge
    keypoints: atol 1e-5 against the plain version, one launch counted,
    masked rows and columns 87..127 exactly zero; an all-masked batch gives
    zeros."""
    rng = np.random.default_rng(K)
    B, L, H, W = 3, 5, 200, 300
    levels = torch.as_tensor(rng.random((B, L, H, W)), dtype=torch.float32, device=cuda)
    uv = torch.as_tensor(rng.uniform(-2.0, 310.0, (B, K, 2)), dtype=torch.float32, device=cuda)
    lvl = torch.as_tensor(rng.integers(0, L, (B, K)), device=cuda)
    sigma = torch.as_tensor(rng.uniform(1.6, 24.0, (B, K)), dtype=torch.float32, device=cuda)
    mask = torch.as_tensor(rng.random((B, K)) > 0.3, device=cuda)
    before = _build.LAUNCHES.get("describe_upright")
    out = dsc.describe_upright(levels, uv, lvl, sigma, mask, keypoints_per_block=kpb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("describe_upright") == before + 1
    ref = dsc.describe_upright_reference(levels, uv, lvl, sigma, mask)
    assert float((out - ref).abs().max()) <= 1e-5
    assert bool((out[~mask] == 0).all()) and bool((out[..., 87:] == 0).all())
    none = dsc.describe_upright(levels, uv, lvl, sigma, torch.zeros_like(mask),
                                keypoints_per_block=kpb)
    assert bool((none == 0).all())
    with pytest.raises(RuntimeError):
        dsc.describe_upright(levels, uv, lvl, sigma, mask, keypoints_per_block=17)


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


def _unit_rows(g, n, d=128):
    x = torch.randn((n, d), generator=g)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _check_top2(out, ref, atol=1e-5):
    """s1/s2 within atol (summation order differs); i1 equal wherever the
    best beats every other column by more than atol.  Returns the number of
    near-tie rows whose index differs."""
    (s1, i1, s2), (r1, j1, r2) = [tuple(x.cpu() for x in t) for t in (out, ref)]
    assert float((s1 - r1).abs().max()) <= atol
    assert float((s2 - r2).abs().max()) <= atol
    clear = (r1 - r2) > atol
    assert bool((i1[clear] == j1[clear]).all())
    return int((i1[~clear] != j1[~clear]).sum())


@pytest.mark.parametrize("Ka,Kb,D", [(256, 2048, 128), (777, 4096, 128), (512, 6144, 64),
                                     (256, 133120, 128), (2048, 133120, 128)])
def test_k4_match_top2_matches_plain(cuda, Ka, Kb, D):
    """Random unit rows with planted exact duplicates (across the boundaries
    of the automatic split and of 2, 5 and 16 splits; ties go to the lower
    index, s2 == s1), zero rows and a query row equal to a landmark: s1/s2
    atol 1e-5, i1 equal outside near-ties; every split count gives the
    unsplit kernel's result bit for bit; launches as the wrapper says (1
    without a split, 2 with one).  The last two shapes take the split path by
    themselves."""
    g = torch.Generator().manual_seed(Ka + Kb)
    a, b = _unit_rows(g, Ka, D), _unit_rows(g, Kb, D)
    n_auto, per = mt.split_plan(Ka, Kb)
    edge = per * mt.TILE_ROWS if n_auto > 1 else Kb // 2    # a split boundary
    b[Kb - 70] = b[33]
    b[Kb - 1] = b[1500 % Kb]
    b[edge] = b[edge - 1]
    b[Kb // 5] = b[Kb // 5 - 1]
    a[5], a[6], a[8], a[9] = b[33], b[Kb - 1], b[edge - 1], b[Kb // 5 - 1]
    b[300:364] = 0.0
    a[7] = 0.0
    da, db = a.to(cuda), b.to(cuda)
    before = _build.LAUNCHES.get("match_top2")
    out = mt.match_top2(da, db, tile_a=1, tile_b=128)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("match_top2") == before + mt.match_top2_launches(Ka, Kb)
    assert mt.match_top2_launches(Ka, Kb) == (2 if n_auto > 1 else 1)
    ref = mt.match_top2_plain(da, db, max_elems=Ka * 1000)
    _check_top2(out, ref)
    assert int(out[1][5]) == 33 and float(out[0][5]) == float(out[2][5])
    assert int(out[1][6]) == 1500 % Kb
    assert int(out[1][8]) == edge - 1 and float(out[0][8]) == float(out[2][8])
    assert int(out[1][9]) == Kb // 5 - 1 and float(out[0][9]) == float(out[2][9])
    _check_top2(out, mt.match_top2_plain(a, b))
    for splits in (1, 2, 5, 16):
        before = _build.LAUNCHES.get("match_top2")
        other = mt.match_top2(da, db, tile_a=1, tile_b=128, splits=splits)
        torch.cuda.synchronize()
        assert _build.LAUNCHES.get("match_top2") == before + mt.match_top2_launches(Ka, Kb, splits)
        for x, y in zip(other, out):
            assert torch.equal(x, y), splits


@pytest.mark.parametrize("tile_rows,stages", [(64, 2), (64, 7), (128, 3), (128, 4)])
def test_k4_other_tiles_and_stages(cuda, tile_rows, stages):
    """The kernel takes its landmark tile (64 or 128 rows) and the depth of
    its ring at run time (the library's defaults are one choice): the same
    result as the default's bit for bit, split or not."""
    g = torch.Generator().manual_seed(tile_rows + stages)
    a = _unit_rows(g, 384).to(cuda).bfloat16().contiguous()
    b = _unit_rows(g, 8192).to(cuda).bfloat16().contiguous()
    base = mt._match_top2_cuda(a, b, 1)
    for splits in (1, 3):
        out = mt._match_top2_cuda(a, b, splits, tile_rows, stages)
        torch.cuda.synchronize()
        for x, y in zip(out, base):
            assert torch.equal(x, y)


def test_k4_match_float_streaming_on_card_matches_cpu(cuda):
    """The streaming matcher with masks and padding (Kb not a tile
    multiple): the same accept set and indices on the card and on the CPU
    except near-ties."""
    g = torch.Generator().manual_seed(9)
    base = _unit_rows(g, 3000)
    a = base[:1500] + 0.05 * torch.randn((1500, 128), generator=g)
    a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True)
    ma = torch.rand(1500, generator=g) > 0.1
    mb = torch.rand(3000, generator=g) > 0.05
    cpu = mt.match_float_streaming(a, base, ma, mb, ratio=0.85)
    gpu = mt.match_float_streaming(a.to(cuda), base.to(cuda), ma.to(cuda), mb.to(cuda),
                                   ratio=0.85)
    assert float((gpu.score.cpu() - cpu.score).abs().max()) <= 1e-5
    agree = (gpu.valid.cpu() == cpu.valid).float().mean()
    assert agree > 0.995 and int(cpu.valid.sum()) > 1000
    both = gpu.valid.cpu() & cpu.valid
    assert bool((gpu.idx.cpu()[both] == cpu.idx[both]).all())


def test_k4_rejects_bad_inputs(cuda):
    """D > 128, a pool that is not a multiple of the kernel's landmark tile
    (``match.TILE_ROWS``), mixed devices, integer inputs, a tile or a ring
    depth the kernel does not have raise; nothing falls back."""
    a = torch.zeros(256, 128, device=cuda)
    with pytest.raises(ValueError):
        mt.match_top2(torch.zeros(256, 160, device=cuda), torch.zeros(2048, 160, device=cuda))
    with pytest.raises(ValueError):
        mt.match_top2(a, torch.zeros(3 * mt.TILE_ROWS // 2, 128, device=cuda),
                      tile_b=mt.TILE_ROWS // 2)
    with pytest.raises(ValueError):
        mt.match_top2(a, torch.zeros(2048, 128))
    with pytest.raises(ValueError):
        mt.match_top2(a.int(), torch.zeros(2048, 128, device=cuda, dtype=torch.int32))
    a16, b16 = a.bfloat16(), torch.zeros(2048, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        mt._match_top2_cuda(a16, b16, 1, 32, 4)           # no 32-row tile
    with pytest.raises(RuntimeError):
        mt._match_top2_cuda(a16, b16, 1, 128, 8)          # the ring would not fit the block


def _pair_descs(g, C, K, D=128, planted=96):
    """Unit descriptors where consecutive images share ``planted`` noisy
    rows (so matches are accepted), an exact duplicate column in image 1
    (ties go to the lower index) and a duplicate row in image 0 (the column
    max keeps the lower row)."""
    base = _unit_rows(g, K, D)
    d = torch.stack([_unit_rows(g, K, D) for _ in range(C)])
    for c in range(C):
        noisy = base[:planted] + 0.05 * torch.randn((planted, D), generator=g)
        d[c, :planted] = noisy / torch.linalg.vector_norm(noisy, dim=1, keepdim=True)
    d[1, K - 1] = d[1, 3]
    d[0, K - 2] = d[0, 5]
    return d


def _check_pairs(got, ref, near, tol=1e-5):
    """score within tol everywhere; valid equal and idx equal on accepted
    rows outside near-ties.  Returns the number of near-tie rows."""
    assert float((got.score - ref.score).abs().max()) <= tol
    clear = ~near
    assert bool((got.valid == ref.valid)[clear].all())
    acc = clear & ref.valid
    assert bool((got.idx == ref.idx)[acc].all())
    return int(near.sum())


@pytest.mark.parametrize("K,D,p_mask", [(256, 128, 0.0), (200, 128, 0.2), (1024, 64, 0.1),
                                         (1024, 128, 0.0), (1000, 128, 0.1), (513, 64, 0.2),
                                         (513, 128, 0.0), (1000, 64, 0.0)])
def test_k5_match_pairs_fused_matches_plain(cuda, K, D, p_mask):
    """K5 against the dense plain matcher on the card, ragged K (a tile that
    runs into the next image's rows) and D < 128 included: score atol 1e-5
    (summation order), valid and accepted idx equal outside near-ties; a
    masked row scores NEG with index 0; two launches counted (the pair
    kernel with the swapped list in it, then finish)."""
    g = torch.Generator().manual_seed(K + D)
    C = 6
    d = _pair_descs(g, C, K, D).to(cuda)
    m = (torch.rand((C, K), generator=g) >= p_mask).to(cuda)
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    before = _build.LAUNCHES.get("match_pairs_fused")
    got = mp.match_pairs_fused(d, m, pairs, ratio=0.85)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("match_pairs_fused") == before + 2
    ref = mm.match_pairs_float(d, m, pairs, ratio=0.85)
    _check_pairs(got, ref, pair_near_ties(d, m, pairs, 0.85))
    assert int(ref.valid.sum()) > 100
    ma = m[torch.as_tensor(pairs[:, 0], device=cuda)]
    assert bool((got.score[~ma] == -1e30).all()) and bool((got.idx[~ma] == 0).all())
    nocc = mp.match_pairs_fused(d, m, pairs, ratio=0.85, cross_check=False)
    assert int(nocc.valid.sum()) >= int(got.valid.sum())


@pytest.mark.parametrize("per_block", [1, 4, 16])
@pytest.mark.parametrize("stages", [2, 4, 6])
def test_k5_pairs_per_block_and_ring_depth(cuda, per_block, stages):
    """Groups of 1, 4 and 16 pairs of one row image a block and rings of 2-6
    stages: the same bits in every field as the default shape (a pair's
    arithmetic does not depend on its group), and the plain matcher's
    result outside near-ties, on an exhaustive list of 9 images, both ways."""
    g = torch.Generator().manual_seed(per_block)
    C, K = 9, 1000
    d = _pair_descs(g, C, K).to(cuda)
    m = (torch.rand((C, K), generator=g) >= 0.1).to(cuda)
    pairs = np.array([(a, b) for a in range(C) for b in range(C) if a != b], np.int32)
    ref = mp.match_pairs_fused(d, m, pairs, ratio=0.85)
    out = (torch.empty((len(pairs), K), dtype=torch.float32, device=cuda),
           torch.empty((len(pairs), K), dtype=torch.int32, device=cuda),
           torch.empty((len(pairs), K), dtype=torch.bool, device=cuda))
    mp.launch(d, m, pairs, out=out, ratio=0.85, name="sweep", pairs_per_block=per_block,
              stages=stages)
    assert torch.equal(out[0], ref.score) and torch.equal(out[1].long(), ref.idx)
    assert torch.equal(out[2], ref.valid)
    _check_pairs(ref, mm.match_pairs_float(d, m, pairs, ratio=0.85),
                 pair_near_ties(d, m, pairs, 0.85))


def test_k5_exact_tie_only_the_lower_row_passes(cuda):
    """Two a-rows with one descriptor tie exactly for their best column (the
    same bf16 products in the same order): only the lower row passes the
    mutual check, on the card as in the plain matcher, for K5, K9 and K10's
    j1."""
    g = torch.Generator().manual_seed(7)
    C, K = 9, 1000
    d = _pair_descs(g, C, K)
    d[0, 700] = d[0, 300]
    d[1, 40] = d[0, 300]
    d[0, 999] = d[0, 1]
    d[1, 600] = d[0, 1]
    d = d.to(cuda)
    m = torch.ones((C, K), dtype=torch.bool, device=cuda)
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, min(a + 9, C))], np.int32)
    for res in (mp.match_pairs_fused(d, m, pairs, ratio=0.85),
                mtl.match_pairs_float_tiled(d, m, pairs, ratio=0.85, min_fill=1),
                mm.match_pairs_float(d, m, pairs, ratio=0.85)):
        assert int(res.idx[0, 300]) == 40 and int(res.idx[0, 700]) == 40
        assert bool(res.valid[0, 300]) and not bool(res.valid[0, 700])
        assert bool(res.valid[0, 1]) and not bool(res.valid[0, 999])
    j1 = mp.match_pairs_top2(d, pairs[:1])[3]
    assert int(j1[0, 40]) == 300 and int(j1[0, 600]) == 1


def test_k10_match_pairs_top2_matches_plain(cuda):
    """K10 (the raw mode): s1/s2 atol 1e-5; i1 equal where the row's best
    two columns differ by more than 1e-5, j1 where the column's best two
    rows do; the planted duplicates resolve to the lower index; one launch
    (the swapped list gives j1 directly, no finish)."""
    g = torch.Generator().manual_seed(10)
    C, K = 5, 384
    d = _pair_descs(g, C, K).to(cuda)
    pairs = np.array([(0, 1), (1, 2), (0, 4), (3, 2), (1, 0)], np.int32)
    before = _build.LAUNCHES.get("match_pairs_top2")
    s1, i1, s2, j1 = mp.match_pairs_top2(d, pairs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("match_pairs_top2") == before + 1
    r1, ri, r2, rj = mp.match_pairs_top2_plain(d, pairs)
    assert float((s1 - r1).abs().max()) <= 1e-5 and float((s2 - r2).abs().max()) <= 1e-5
    assert bool((i1 == ri)[(r1 - r2) > 1e-5].all())
    p = torch.as_tensor(pairs, device=cuda).long()
    sim = (d[p[:, 0]].bfloat16().float() @ d[p[:, 1]].bfloat16().float().transpose(1, 2))
    cv = torch.topk(sim, 2, dim=1).values
    assert bool((j1 == rj)[(cv[:, 0] - cv[:, 1]) > 1e-5].all())
    # pair (1,0): image 1's rows 3 and K-1 are equal, as are image 0's
    # columns 5 and K-2, so the higher of each never wins
    assert not bool((j1[4] == K - 1).any()) and not bool((i1[4] == K - 2).any())


def test_k9_tiled_equals_k5_exactly(cuda):
    """K9 on a band of 24 images (window 6) plus sparse extras: identical
    to K5 on the same pairs in every field (the same arithmetic per
    element), and to the plain matcher outside near-ties; the band goes
    through K9, the leftovers through K5."""
    g = torch.Generator().manual_seed(24)
    C, K = 24, 256
    d = _pair_descs(g, C, K).to(cuda)
    m = (torch.rand((C, K), generator=g) > 0.1).to(cuda)
    band = {(a, b) for a in range(C) for b in range(a + 1, min(a + 7, C))}
    band |= {(0, 20), (3, 17), (5, 22), (1, 12)}
    pairs = np.array(sorted(band), np.int32)
    t0, f0 = _build.LAUNCHES.get("match_pairs_tiled"), _build.LAUNCHES.get("match_pairs_fused")
    got = mtl.match_pairs_float_tiled(d, m, pairs, ratio=0.85)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("match_pairs_tiled") == t0 + 2
    assert _build.LAUNCHES.get("match_pairs_fused") == f0 + 2
    k5 = mp.match_pairs_fused(d, m, pairs, ratio=0.85)
    for x, y in zip(got, k5):
        assert torch.equal(x, y)
    _check_pairs(got, mm.match_pairs_float(d, m, pairs, ratio=0.85),
                 pair_near_ties(d, m, pairs, 0.85))


def test_auto_dispatch_never_runs_plain_on_card(cuda, monkeypatch):
    """On CUDA tensors "auto"/"pallas" launch K5 and "tiles" K9 (or K5 for
    fewer than 8 images); the plain matcher is never called; D > 128
    raises; "dense" is the plain matcher by choice."""
    g = torch.Generator().manual_seed(3)
    d = _pair_descs(g, 9, 128).to(cuda)
    m = torch.ones((9, 128), dtype=torch.bool, device=cuda)
    pairs = np.array([(a, b) for a in range(9) for b in range(a + 1, 9)], np.int32)
    dense = mm.match_pairs_float(d, m, pairs)

    def no_plain(*a, **k):
        raise AssertionError("plain matcher called on the card")

    monkeypatch.setattr(mm, "match_pairs_float", no_plain)
    monkeypatch.setattr(mp, "match_pairs_float", no_plain)
    monkeypatch.setattr(mtl, "match_pairs_float", no_plain)
    for kernel, name in (("auto", "match_pairs_fused"), ("pallas", "match_pairs_fused"),
                         ("tiles", "match_pairs_tiled")):
        before = _build.LAUNCHES.get(name)
        r = mm.match_pairs_float_auto(d, m, pairs, kernel=kernel, ratio=0.8)
        assert _build.LAUNCHES.get(name) > before, kernel
        assert bool((r.valid == dense.valid).float().mean() > 0.99)
    with pytest.raises(ValueError):
        mm.match_pairs_float_auto(torch.zeros((2, 64, 160), device=cuda), m[:2, :64],
                                  np.array([[0, 1]], np.int32))
    with pytest.raises(AssertionError):
        mm.match_pairs_float_auto(d, m, pairs, kernel="dense")


# ---------------------------------------------------------------------------
# K6-K8: the fused bundle-adjustment kernels
# ---------------------------------------------------------------------------

# (C, P, O, tp_cap, long tracks): P not a multiple of the 128-point block,
# the last camera and the last 3 points without observations, and with
# long tracks more observations than slots (overflow left out of the layout)
# a fourth shape with tp = 64 and tracks of ~30 views (several slots per
# thread of K6's point pass); every shape has points with no slot (cnt = 0)
BA_SHAPES = [(24, 600, 4000, 32, 0), (37, 1001, 5000, 4, 8), (5, 131, 300, 8, 0),
             (96, 500, 15000, 64, 12)]


def _ba_case(dev, C, P, O, tp, longs, delta=1.0 / 500.0):
    """A problem on ``dev`` with its layout and packed observations."""
    p = {k: torch.as_tensor(v, device=dev) for k, v in
         ba_problem(C, P, O, seed=C, long_tracks=longs, perturb=0.01).items()}
    d = sg.build_dense_obs(p["pt_id"], p["cam_id"], P, C, tp)
    uvw = sg.pack_rows(d, torch.cat([p["uv"], p["w_valid"][:, None]], 1))
    cam19 = sg.build_cam_table(p["intr"], p["k_idx"], p["R"], p["t"])
    return p, d, uvw, cam19, p["X"].T.contiguous(), delta


def _rel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-20))


@pytest.mark.parametrize("shape", BA_SHAPES)
def test_k7_ba_assemble_matches_plain(cuda, shape):
    """U, V9, Wp within 1e-4 of the largest entry (the residual is a
    difference of pixel coordinates ~300 that leaves ~0.3, so an FMA
    contracted otherwise moves it by ~3e-5 relative, and a Huber weight
    delta/|r| repeats that), b_c and b_p within 1e-3 (near-cancelling sums
    on top), cost rtol 1e-4; two launches counted; a camera without
    observations gets zero blocks."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    before = _build.LAUNCHES.get("ba_assemble_fused")
    U, bc, v13, Wp = sg.ba_assemble_fused(cam19, d, uvw, x3, delta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("ba_assemble_fused") == before + 2
    rU, rbc, rv13, rWp = sg.ba_assemble_fused_plain(cam19, d.camp, uvw, x3, delta)
    assert _rel(U, rU) < 1e-4 and _rel(v13[:9], rv13[:9]) < 1e-4 and _rel(Wp, rWp) < 1e-4
    assert _rel(bc, rbc) < 1e-3 and _rel(v13[9:12], rv13[9:12]) < 1e-3
    assert abs(float(v13[12].sum()) - float(rv13[12].sum())) <= 1e-4 * float(rv13[12].sum())
    assert torch.equal(U, U.transpose(1, 2))
    assert float(U[-1].abs().max()) == 0.0 and float(bc[-1].abs().max()) == 0.0
    assert float(v13[:, -3:].abs().max()) == 0.0 and torch.isfinite(Wp).all()


@pytest.mark.parametrize("shape", BA_SHAPES)
def test_k7_slot_groups_and_repeat(cuda, shape):
    """K7 at several slot-group counts: within the plain version's
    tolerances; two calls bit-equal in all four outputs, the bound object
    equal to the one-shot wrapper; more groups than a block holds raise."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    rU, rbc, rv13, rWp = sg.ba_assemble_fused_plain(cam19, d.camp, uvw, x3, delta)
    bound = sg.AssembleFused(d, uvw)
    first = bound(cam19, x3, delta)
    for x, y in zip(first, bound(cam19, x3, delta)):
        assert torch.equal(x, y)
    for x, y in zip(first, sg.ba_assemble_fused(cam19, d, uvw, x3, delta)):
        assert torch.equal(x, y)
    for groups in (1, 2, 5, 16):
        U, bc, v13, Wp = bound(cam19, x3, delta, groups=groups)
        assert _rel(U, rU) < 1e-4 and _rel(v13[:9], rv13[:9]) < 1e-4 and _rel(Wp, rWp) < 1e-4
        assert _rel(bc, rbc) < 1e-3 and _rel(v13[9:12], rv13[9:12]) < 1e-3
    with pytest.raises(RuntimeError):
        bound(cam19, x3, delta, groups=32)


@pytest.mark.parametrize("shape", BA_SHAPES)
@pytest.mark.parametrize("use", ["matvec", "rhs", "backsub"])
def test_k6_schur_matvec_matches_plain(cuda, shape, use):
    """The kernel's three uses on a system K7 assembled: z and vy within
    rtol 1e-4 plus 1e-4 of the largest entry (f32 sums of up to tp*6
    products in another order); twice the same bits."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    C, P = shape[0], shape[1]
    U, bc, v13, Wp = sg.ba_assemble_fused(cam19, d, uvw, x3, delta)
    vinv = schur._damp_inv3_rows(v13[:9], 1e-3).contiguous()
    bp = v13[9:12].contiguous()
    x = torch.randn((6, C), generator=torch.Generator().manual_seed(1)).to(cuda)
    x6, bias = {"matvec": (x, None), "rhs": (torch.zeros_like(x), bp), "backsub": (x, -bp)}[use]
    before = _build.LAUNCHES.get("schur_cross_matvec")
    z, vy = sg.schur_cross_matvec(Wp, d, vinv, x6, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("schur_cross_matvec") == before + 2
    rz, rvy = sg.schur_cross_matvec_plain(Wp, d.camp, vinv, x6, bias)
    for got, ref in ((z, rz), (vy, rvy)):
        assert bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-4 * ref.abs().max()).all())
    z2, vy2 = sg.schur_cross_matvec(Wp, d, vinv, x6, bias)
    assert torch.equal(z, z2) and torch.equal(vy, vy2)
    assert float(z[:, -1].abs().max()) == 0.0
    assert int((d.cnt == 0).sum()) >= 3               # points without a slot ride along
    # the system bound once (what the PCG loop calls), and other slot groups
    bound = sg.SchurMatvec(Wp, d, vinv)
    z3, vy3 = bound(x6, bias)
    assert torch.equal(z, z3) and torch.equal(vy, vy3)
    for groups in (1, 32):
        zg, vyg = bound(x6, bias, groups=groups)
        for got, ref in ((zg, rz), (vyg, rvy)):
            assert bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-4 * ref.abs().max()).all())


@pytest.mark.parametrize("shape", BA_SHAPES)
@pytest.mark.parametrize("nc", [1, 4])
def test_k8_ba_cost_matches_plain(cuda, shape, nc):
    """nc stacked candidates: rtol 1e-4 against the plain version (the
    residual's cancellation, see K7), and the first candidate equal to K7's
    cost to 1e-6 (one shared projection)."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    cams = torch.cat([sg.build_cam_table(p["intr"], p["k_idx"], p["R"], p["t"] + 0.01 * c)
                      for c in range(nc)], 0)
    xs = torch.cat([(p["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
    before = _build.LAUNCHES.get("ba_cost_fused")
    got = sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=nc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("ba_cost_fused") == before + 1
    ref = sg.ba_cost_fused_plain(cams, d.camp, uvw, xs, delta, nc)
    assert torch.allclose(got, ref, rtol=1e-4, atol=0.0)
    c7 = float(sg.ba_assemble_fused(cam19, d, uvw, x3, delta)[2][12].sum())
    assert abs(float(got[0]) - c7) <= 1e-6 * c7


def _k8_candidates(p, nc):
    cams = torch.cat([sg.build_cam_table(p["intr"], p["k_idx"], p["R"], p["t"] + 0.01 * c)
                      for c in range(nc)], 0)
    xs = torch.cat([(p["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
    return cams, xs


@pytest.mark.parametrize("shape", BA_SHAPES)
def test_k8_bit_reproducible_and_position_invariant(cuda, shape):
    """Two calls give the same bits; a candidate's cost is bit-equal from an
    nc = 1 launch and from every place among 4 (the LM loop compares the
    two), with the camera tables staged in shared memory or not."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    cams, xs = _k8_candidates(p, 4)
    got = sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=4)
    assert torch.equal(got, sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=4))
    assert torch.equal(got, sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=4, stage=False))
    assert torch.equal(got, sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=4, stage=True))
    for order in ([3, 2, 1, 0], [1, 3, 0, 2]):
        ix = torch.tensor(order, device=cuda)
        perm = sg.ba_cost_fused(cams.reshape(4, 19, -1)[ix].reshape(76, -1).contiguous(), d, uvw,
                                xs.reshape(4, 3, -1)[ix].reshape(12, -1).contiguous(), delta, nc=4)
        assert torch.equal(perm, got[ix])
    for c in range(4):
        for stage in (False, True):
            one = sg.ba_cost_fused(cams[19 * c:19 * c + 19], d, uvw, xs[3 * c:3 * c + 3], delta,
                                   nc=1, stage=stage)
            assert torch.equal(one, got[c:c + 1])


@pytest.mark.parametrize("shape", BA_SHAPES)
def test_k8_other_slot_groups(cuda, shape):
    """Slot-group counts the kernel takes (1..16 threads a point), the
    camera tables staged or not, 4 and 16 candidates (the two compiled
    widths): within rtol 1e-4 of the plain version; more groups than a block
    holds raise."""
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *shape)
    for nc, group_set in ((4, (1, 2, 3, 8, 16)), (16, (1, 5, 16))):
        cams, xs = _k8_candidates(p, nc)
        ref = sg.ba_cost_fused_plain(cams, d.camp, uvw, xs, delta, nc)
        for groups in group_set:
            for stage in (False, True):
                got = sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=nc, groups=groups, stage=stage)
                assert torch.allclose(got, ref, rtol=1e-4, atol=0.0), (nc, groups, stage)
    with pytest.raises(RuntimeError):
        sg.ba_cost_fused(cams, d, uvw, xs, delta, nc=16, groups=32)


def test_ba_wrappers_reject_bad_inputs(cuda):
    p, d, uvw, cam19, x3, delta = _ba_case(cuda, *BA_SHAPES[0])
    with pytest.raises(ValueError):
        sg.ba_assemble_fused(cam19.cpu(), d, uvw, x3, delta)          # mixed devices
    with pytest.raises(ValueError):
        sg.ba_assemble_fused(cam19, d, uvw, x3[:, :-1].contiguous(), delta)
    with pytest.raises(ValueError):
        sg.ba_cost_fused(cam19.double(), d, uvw, x3, delta, nc=1)
    with pytest.raises(ValueError):
        sg.ba_cost_fused(cam19.repeat(17, 1), d, uvw, x3.repeat(17, 1), delta, nc=17)
    with pytest.raises(ValueError):
        sg.schur_cross_matvec(torch.zeros((32 * 18, 600), device=cuda), d,
                              torch.zeros((9, 600), device=cuda).T, torch.zeros((6, 24), device=cuda))


@pytest.mark.parametrize("path", ["planes", "dense", "dense-overflow"])
def test_ba_solve_on_card_matches_cpu(cuda, path):
    """One solve on the card (K6-K8 on the dense paths) against the plain
    path on the CPU: first cost rtol 1e-4, final cost within 2 %, poses and
    points within 2e-2 of a scene 25 units deep (LM amplifies summation-order
    differences along the free scale gauge, which only damping holds: the
    planes path, all PyTorch, moves by 1.5e-3 between the card and the CPU);
    the dense solve
    launches K7 once, K6 cg_iters+2 times and K8 once per LM iteration, plus
    K8 once for the first cost (two CUDA kernels each for K6 and K7)."""
    C, P, O, tp, longs = BA_SHAPES[1]
    prob = ba_problem(C, P, O, seed=3, long_tracks=longs, perturb=0.03)
    lens = np.bincount(prob["pt_id"], minlength=P)
    kw = {"planes": {}, "dense": dict(tp_cap=int(lens.max()), dense_cg=True),
          "dense-overflow": dict(tp_cap=tp, dense_cg=True,
                                 ov_cap=int(np.maximum(lens - tp, 0).sum()))}[path]
    iters, cg = 6, 20
    _build.LAUNCHES.reset()
    out = lm.ba_solve(*(torch.as_tensor(v, device=cuda) for v in prob.values()),
                      iters=iters, cg_iters=cg, **kw)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES.counts)
    ref = lm.ba_solve(*(torch.as_tensor(v) for v in prob.values()), iters=iters, cg_iters=cg, **kw)
    if path == "planes":
        assert counts == {}
    else:
        assert counts == {"ba_assemble_fused": 2 * iters,
                          "schur_cross_matvec": 2 * iters * (cg + 2),
                          "ba_cost_fused": iters + 1}
    cc, cr = out[3].cpu(), ref[3]
    assert abs(float(cc[0]) - float(cr[0])) <= 1e-4 * float(cr[0])
    assert abs(float(cc[-1]) - float(cr[-1])) <= 0.02 * float(cr[-1])
    assert float(cc[-1]) < 0.2 * float(cc[0])
    for a, b in zip(out[:3], ref[:3]):
        assert float((a.cpu() - b).abs().max()) < 2e-2


def _textured(B=2, H=160, W=200, seed=5):
    """Smooth blob textures (random Gaussian blobs), (B,H,W) in [0,1]."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    out = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for _ in range(60):
            cy, cx, s = rng.uniform(15, H - 15), rng.uniform(15, W - 15), rng.uniform(2, 6)
            out[b] += rng.uniform(0.3, 1.0) * rng.choice([-1, 1]) * np.exp(
                -((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
        out[b] = (out[b] - out[b].min()) / (out[b].max() - out[b].min())
    return torch.from_numpy(out)


def _agreeing_share(got, ref, tol_px=0.01, tol_rad=1e-3, tol_desc=1e-3):
    """Share of the reference's valid keypoints with a card keypoint within
    tol_px whose angle is within tol_rad (mod 2 pi), and the largest
    descriptor difference over those."""
    shares, worst = [], 0.0
    for b in range(ref.kp.mask.shape[0]):
        rm, gm = ref.kp.mask[b], got.kp.mask[b].cpu()
        d = torch.cdist(ref.kp.uv[b][rm].double(), got.kp.uv[b].cpu()[gm].double())
        dmin, j = d.min(dim=1)
        da = torch.remainder(ref.kp.angle[b][rm] - got.kp.angle[b].cpu()[gm][j] + np.pi,
                             2 * np.pi) - np.pi
        good = (dmin < tol_px) & (da.abs() < tol_rad)
        shares.append(float(good.double().mean()))
        dd = (ref.desc[b][rm] - got.desc[b].cpu()[gm][j]).abs().amax(dim=1)[good]
        worst = max(worst, float(dd.max()) if len(dd) else 0.0)
    return min(shares), worst


@pytest.mark.parametrize("n_octaves", [1, 2])
def test_oriented_extraction_on_card_matches_cpu(cuda, n_octaves):
    """Oriented extraction: K1/K2 then the rotated-patch gathers on the
    card against the plain path on the CPU from the same images: >= 95 % of
    the CPU's keypoints within 0.01 px and 1e-3 rad, their descriptors
    within 1e-3 (K1 differs from its plain version by up to 1e-5, which can
    move a keypoint's subpixel fit or NMS)."""
    img = _textured()
    ref = F.detect_and_describe(img, max_keypoints=256, threshold=1e-7, oriented=True,
                                n_octaves=n_octaves)
    got = F.detect_and_describe(img.to(cuda), max_keypoints=256, threshold=1e-7,
                                oriented=True, n_octaves=n_octaves)
    share, worst = _agreeing_share(got, ref)
    assert share >= 0.95 and worst < 1e-3, (share, worst)


def test_sift_extraction_on_card_matches_cpu(cuda):
    """SIFT (plain torch, cuDNN's blur on the card): the same share and
    tolerances against the CPU from the same images."""
    from sfmx_torch.kernels import sift

    img = _textured(seed=6)
    ref = sift.detect_and_describe_sift(img, max_keypoints=256, n_octaves=2, oriented=True)
    got = sift.detect_and_describe_sift(img.to(cuda), max_keypoints=256, n_octaves=2,
                                        oriented=True)
    share, worst = _agreeing_share(got, ref)
    assert share >= 0.95 and worst < 1e-3, (share, worst)
