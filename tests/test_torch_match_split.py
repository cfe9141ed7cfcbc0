"""K4's two decompositions on the CPU: the split of the landmark loop with
its ordered merge (``match.match_top2_split_plain``, the plain-PyTorch mirror
of what the kernel's grid and its merge launch do) and the filtered fold of a
tile into a thread's running top-2 (emulated here in numpy with the kernel's
accumulator layout).  The CUDA kernel's own checks are in test_torch_gpu.py.

Tolerances, and why:
- split + merge against ``match_top2_plain`` and ``match_top2_reference``:
  equal in every field.  A split is a contiguous range of whole tiles, its
  scores are the same f32 matmul on the same bf16-rounded rows, and top-2
  with the lowest index on a tie is a function of the set of (score, index)
  pairs, so no merge order may change it.  The cases on quantized inputs
  (entries k/8, every partial sum exact in f32) cannot depend on how the
  CPU's matmul blocks a slice; they are full of exact ties.
- filtered fold against the unfiltered fold: bit-equal.  A score that does
  not exceed the running second changes neither the best, its index nor the
  second, so skipping a tile whose maximum does not exceed it changes nothing.
- plain K4 against the Pallas kernel in interpret mode: atol 1e-6 on scores,
  indices equal, as ``tests/test_torch_match.py`` states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels.pallas_match import match_top2 as jtop2
from sfmx_torch.kernels import match as tmatch

torch.set_num_threads(2)
NEG = np.float32(-1e30)
SPLITS = [1, 2, 5, 16]


def unit_rows(rng, n, d=128):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def quantized_rows(rng, n, d=128):
    """Entries k/8, |k| <= 4: exact in bf16, and every sum of 128 products
    (multiples of 1/64, at most 32 in size) is exact in f32 in any order."""
    return (rng.integers(-4, 5, (n, d)) / 8.0).astype(np.float32)


def planted(rng, Ka, Kb, rows):
    """Queries and a pool with exact duplicate pairs that straddle the
    boundaries of 2 and 16 splits (rows Kb/2 - 1, Kb/2) and of 5 splits (rows
    Kb/5 - 1, Kb/5) where the pool is 80 tiles: the lower index must win with
    s2 == s1; a duplicate pair far apart; a query whose best lies in the
    first split and whose second in the last; zeroed query and pool rows, and
    a zero-padded pool tail."""
    a, b = rows(rng, Ka), rows(rng, Kb)
    h, q = Kb // 2, Kb // 5
    b[h] = b[h - 1]
    b[q] = b[q - 1]
    b[3 * Kb // 4 + 3] = b[70]
    a[0], a[1], a[4] = b[h - 1], b[q - 1], b[70]
    b[Kb - 300] = 0.75 * b[100]             # a[2]: best in the first split, second in the last
    a[2] = b[100]
    a[3] = 0.0
    b[Kb // 3:Kb // 3 + 9] = 0.0
    b[Kb - 20:] = 0.0                       # the streaming matcher's zero padding
    return a, b


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kind", ["quantized", "unit"])
def test_split_merge_equals_plain_in_every_field(kind, splits):
    """1, 2, 5 and 16 splits of an 80-tile pool: s1, i1 and s2 equal to the
    plain version's and the dense oracle's; the planted ties resolve to the
    lower index with s2 == s1; the zero query row scores 0."""
    rng = np.random.default_rng(7)
    tile, Ka, Kb = 64, 96, 80 * 64
    a, b = planted(rng, Ka, Kb, quantized_rows if kind == "quantized" else unit_rows)
    assert tmatch.split_plan(Ka, Kb, splits, tile_rows=tile) == (splits, 80 // splits)
    out = tmatch.match_top2_split_plain(T(a), T(b), splits, tile_rows=tile)
    plain = tmatch.match_top2_plain(T(a), T(b))
    dense = tmatch.match_top2_reference(T(a), T(b))
    for got, r1, r2 in zip(out, plain, dense):
        assert got.dtype == r1.dtype and torch.equal(got, r1) and torch.equal(got, r2)
    s1, i1, s2 = (x.numpy() for x in out)
    assert i1[0] == Kb // 2 - 1 and i1[1] == Kb // 5 - 1 and i1[4] == 70
    assert s1[0] == s2[0] and s1[1] == s2[1] and s1[4] == s2[4]
    assert i1[2] == 100 and abs(s2[2] - 0.75 * s1[2]) < 1e-2 * s1[2]
    assert s1[3] == 0.0 and s2[3] == 0.0 and i1[3] == 0


@pytest.mark.parametrize("Ka,Kb,n_auto", [
    (32768, 133120, 1),      # the serving batch's 256 row blocks fill the card: no split
    (16384, 133120, 1),
    (2048, 133120, 8),       # the burst's tail: 16 row blocks x 8 splits of 130 tiles
    (256, 133120, 65),       # 2 row blocks x 65 ranges of 16 tiles
    (256, 2048, 16),         # never more splits than tiles
    (0, 2048, None),
])
def test_split_plan_covers_the_pool(Ka, Kb, n_auto):
    """The automatic plan: 1 where the row blocks fill 132 SMs, else about one
    block per SM; ranges are whole tiles, none empty, together the pool; a
    requested count shrinks to the most that leaves no range empty; the
    launch count is 1 without a split and 2 with one."""
    tile = tmatch.TILE_ROWS
    tiles = Kb // tile
    n, per = tmatch.split_plan(Ka, Kb)
    assert (n - 1) * per < tiles <= n * per
    if Ka:
        assert n == n_auto
        assert n == 1 or -(-Ka // tmatch.BLOCK_ROWS) * n <= tmatch.SPLIT_TARGET_BLOCKS
        assert tmatch.match_top2_launches(Ka, Kb) == (1 if n == 1 else 2)
        assert tmatch.match_top2_launches(Ka, Kb, splits=1) == 1
    else:
        assert tmatch.match_top2_launches(Ka, Kb) == 0
    for asked in (1, 3, 7, 1000):
        m, p = tmatch.split_plan(Ka, Kb, asked)
        assert 1 <= m <= min(asked, tiles) and (m - 1) * p < tiles <= m * p


def test_split_mirror_matches_pallas_kernel():
    """The split mirror against the reference's Pallas kernel in interpret
    mode on the same numpy inputs: scores atol 1e-6, indices equal."""
    rng = np.random.default_rng(11)
    a, b = planted(rng, 64, 20 * 64, unit_rows)
    s1, i1, s2 = (np.asarray(x) for x in jtop2(jnp.asarray(a), jnp.asarray(b), tile_a=32,
                                                tile_b=64, interpret=True))
    out = tmatch.match_top2_split_plain(T(a), T(b), 5, tile_rows=64)
    np.testing.assert_allclose(out[0].numpy(), s1, atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), s2, atol=1e-6)
    np.testing.assert_array_equal(out[1].numpy(), i1)


# ---------------------------------------------------------------------------
# The fold of a tile into a thread's running top-2, as the kernel does it
# ---------------------------------------------------------------------------


def _fold(s, j, b1, b2, i1):
    """The kernel's ``fold``, on arrays of running states."""
    gt = s > b1
    b2 = np.where(gt, b1, np.maximum(b2, s))
    i1 = np.where(gt, j, i1)
    b1 = np.where(gt, s, b1)
    return b1, b2, i1


def kernel_top2(sim: np.ndarray, tile: int, filtered: bool):
    """Emulate a consumer's work on the (rows, Kb) scores: thread t of a
    row's quad owns columns 8i + 2t, 8i + 2t + 1 of every tile and folds
    them in increasing order; with ``filtered`` a tile enters the fold only
    where its maximum over the thread's columns exceeds the thread's running
    second.  Then the quad merges (xor 1, xor 2), ties to the lower index.
    Returns (s1, i1, s2) and the share of (thread, tile) folds entered."""
    R, Kb = sim.shape
    b1 = np.full((R, 4), NEG, np.float32)
    b2 = np.full((R, 4), NEG, np.float32)
    i1 = np.zeros((R, 4), np.int64)
    t = np.arange(4)
    entered = total = 0
    for c0 in range(0, Kb, tile):
        cols = (c0 + 8 * np.arange(tile // 8)[:, None, None] + 2 * t[None, :, None]
                + np.arange(2)[None, None, :])                   # (tile/8, 4, 2)
        order = cols.transpose(1, 0, 2).reshape(4, -1)          # per thread, increasing
        vals = sim[:, order]                                     # (R, 4, tile/4)
        go = vals.max(axis=2) > b2 if filtered else np.ones((R, 4), bool)
        entered += int(go.sum())
        total += go.size
        n1, n2, ni = b1, b2, i1
        for k in range(order.shape[1]):
            n1, n2, ni = _fold(vals[:, :, k], order[None, :, k], n1, n2, ni)
        b1, b2, i1 = np.where(go, n1, b1), np.where(go, n2, b2), np.where(go, ni, i1)
    for off in (1, 2):
        o1, o2, oi = b1[:, t ^ off], b2[:, t ^ off], i1[:, t ^ off]
        take = (o1 > b1) | ((o1 == b1) & (oi < i1))
        b2 = np.maximum(np.minimum(b1, o1), np.maximum(b2, o2))
        i1 = np.where(take, oi, i1)
        b1 = np.where(take, o1, b1)
    return b1[:, 0], i1[:, 0].astype(np.int32), b2[:, 0], entered / total


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("kind", ["quantized", "unit"])
def test_filtered_fold_is_bit_equal_to_unfiltered(kind, tile):
    """The filtered fold equals the unfiltered one bit for bit and both equal
    the plain version, with planted ties and a tile whose maximum EQUALS the
    running second (it is skipped, and nothing would have changed); on unit
    rows the filter skips most folds after the first tiles."""
    rng = np.random.default_rng(tile)
    Ka, Kb = 48, 16 * tile
    a, b = planted(rng, Ka, Kb, quantized_rows if kind == "quantized" else unit_rows)
    # row 5: tile 2 holds the best twice, so the second equals the best; every
    # later copy of that score has a maximum equal to the running second
    b[2 * tile] = b[2 * tile + 8] = b[6 * tile] = b[9 * tile + 16] = a[5]
    a16 = T(a).to(torch.bfloat16).to(torch.float32)
    b16 = T(b).to(torch.bfloat16).to(torch.float32)
    sim = (a16 @ b16.T).numpy()
    f1, fi, f2, share = kernel_top2(sim, tile, filtered=True)
    u1, ui, u2, _ = kernel_top2(sim, tile, filtered=False)
    np.testing.assert_array_equal(f1, u1)
    np.testing.assert_array_equal(fi, ui)
    np.testing.assert_array_equal(f2, u2)
    p1, pi, p2 = (x.numpy() for x in tmatch.match_top2_plain(T(a), T(b)))
    np.testing.assert_array_equal(f1, p1)
    np.testing.assert_array_equal(fi, pi)
    np.testing.assert_array_equal(f2, p2)
    assert fi[5] == 2 * tile and f1[5] == f2[5]
    if kind == "unit":
        assert share < 0.6, share
