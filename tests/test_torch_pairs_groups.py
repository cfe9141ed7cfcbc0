"""K5's work decomposition on the CPU: the wrapper's grouping of the pair
list by row image, and the column's best row taken as the swapped pair's
best column (``pairs.match_pairs_swapped_plain``, a plain mirror of what the
CUDA kernel computes), against the port's dense matcher and ``sfmx``'s.

Tolerances: the mirror and the port's plain matcher share one similarity
matrix, so every field is compared exactly; against the reference (XLA's
CPU dot, another summation order) scores agree to 1e-6 and the accept sets
and winning indices outside near-ties (``smoke_scenes.pair_near_ties``).
"""
import numpy as np
import pytest
import torch

from sfmx.kernels import matching as jm
from sfmx_torch.core.masking import NEG_INF, topk_lowest_index
from sfmx_torch.kernels import matching as tm
from sfmx_torch.kernels import pairs as tp
from tests.smoke_scenes import pair_near_ties

torch.set_num_threads(2)


def _descs(rng, C, K, D=128, planted=None):
    """Unit descriptors where neighbouring images share noisy copies of
    their first rows, so that matches pass the ratio test."""
    planted = K // 4 if planted is None else planted
    d = rng.standard_normal((C, K, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for c in range(1, C):
        d[c, :planted] = d[c - 1, :planted] + 0.05 * rng.standard_normal((planted, D))
        d[c] /= np.linalg.norm(d[c], axis=-1, keepdims=True)
    return d


def _col_argmax(descs, masks, pairs):
    """The dense matcher's column best row of each pair: the lowest row
    attaining the max over the masked similarity."""
    p = torch.as_tensor(pairs).long()
    sim = tm._masked(tm._bf16_sim(descs[p[:, 0]], descs[p[:, 1]]), masks[p[:, 0]], masks[p[:, 1]])
    return topk_lowest_index(sim.transpose(-1, -2), 1)[1][..., 0]


PAIR_LISTS = {
    "exhaustive": np.array([(a, b) for a in range(12) for b in range(a + 1, 12)], np.int32),
    "band": np.array([(a, b) for a in range(20) for b in range(a + 1, min(a + 7, 20))], np.int32),
    "unsorted-both-ways": np.random.default_rng(3).integers(0, 9, (60, 2)).astype(np.int32),
}


@pytest.mark.parametrize("per_block", [1, 3, 8, 16])
@pytest.mark.parametrize("name", list(PAIR_LISTS))
def test_group_pairs_cover_each_pair_once(name, per_block):
    """Every listed pair lands in exactly one group, a group holds 1 to
    per_block pairs of one row image, an image's pairs keep their list
    order, and out_row puts each result back at its place in the list."""
    pairs = PAIR_LISTS[name]
    out_row = np.arange(len(pairs), dtype=np.int32)
    ps, orow, gs = tp.group_pairs(pairs, out_row, per_block)
    assert sorted(orow.tolist()) == list(range(len(pairs)))
    assert np.array_equal(ps, pairs[orow])
    assert gs[0] == 0 and gs[-1] == len(pairs) and gs.dtype == np.int32
    sizes = np.diff(gs)
    assert sizes.min() >= 1 and sizes.max() <= per_block
    for s, e in zip(gs[:-1], gs[1:]):
        assert len(set(ps[s:e, 0].tolist())) == 1
    for a in np.unique(pairs[:, 0]):
        mine = orow[ps[:, 0] == a]
        assert np.all(np.diff(mine) > 0)
    # a group is all of an image's pairs unless that image has more than per_block
    counts = np.bincount(pairs[:, 0])
    assert len(sizes) == sum(-(-int(c) // per_block) for c in counts if c)


@pytest.mark.parametrize("K,p_mask", [(1024, 0.1), (1000, 0.2), (513, 0.3), (513, 0.0)])
def test_swapped_mirror_equals_plain_matcher(K, p_mask):
    """The decomposition the kernel runs (grouped lists, tiles padded past K
    with the next image's rows, a column bias, the swapped list for the
    column's best row) gives the dense plain matcher's score, idx and valid
    exactly, with and without the cross-check, and its column argmax at
    every unmasked column."""
    rng = np.random.default_rng(K)
    C = 4
    d = torch.from_numpy(_descs(rng, C, K, D=64))
    m = torch.from_numpy(rng.random((C, K)) >= p_mask)
    pairs = np.array([(0, 1), (2, 1), (1, 2), (0, 3), (3, 0), (2, 3)], np.int32)
    for cross_check in (True, False):
        got, j1 = tp.match_pairs_swapped_plain(d, m, pairs, ratio=0.85, cross_check=cross_check,
                                               per_block=2)
        ref = tm.match_pairs_float(d, m, pairs, ratio=0.85, cross_check=cross_check)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
    assert int(ref.valid.sum()) > 50
    col = m[torch.as_tensor(pairs[:, 1]).long()]
    assert torch.equal(j1[col], _col_argmax(d, m, pairs)[col])


def test_exact_tie_only_the_lower_row_passes():
    """Two a-rows with the same descriptor give bit-identical scores in any
    order: they tie exactly for their best column, and only the lower row
    passes the mutual check (the dense matcher's index rule; a comparison
    of values, the TPU kernel's, would accept both).  The mirror, the
    port's plain matcher and the reference agree."""
    rng = np.random.default_rng(5)
    C, K = 3, 256
    d = _descs(rng, C, K)
    d[0, 9] = d[0, 3]                 # rows 3 and 9 of image 0 are one descriptor...
    d[1, 40] = d[0, 3]                # ...which image 1 holds at column 40
    d[0, 200] = d[0, 150]             # and a tie the lower row wins at another column
    d[1, 77] = d[0, 150]
    m = np.ones((C, K), bool)
    pairs = np.array([(0, 1), (1, 0)], np.int32)
    td, tmk = torch.from_numpy(d), torch.from_numpy(m)
    got, j1 = tp.match_pairs_swapped_plain(td, tmk, pairs, ratio=0.85)
    ref = tm.match_pairs_float(td, tmk, pairs, ratio=0.85)
    jref = jm.match_pairs_float(d, m, pairs, ratio=0.85)
    for res in (got, ref, tm.MatchResult.from_numpy(jref, "cpu")):
        assert int(res.idx[0, 3]) == 40 and int(res.idx[0, 9]) == 40
        assert bool(res.valid[0, 3]) and not bool(res.valid[0, 9])
        assert bool(res.valid[0, 150]) and not bool(res.valid[0, 200])
        assert int(res.idx[1, 40]) == 3 and bool(res.valid[1, 40])
    assert int(j1[0, 40]) == 3 and int(j1[0, 77]) == 150


@pytest.mark.parametrize("K,p_mask", [(256, 0.0), (200, 0.2)])
def test_swapped_mirror_matches_reference_dense_matcher(K, p_mask):
    """The mirror against ``sfmx.kernels.matching.match_pairs_float`` (JAX on
    the CPU) on the same numpy inputs."""
    rng = np.random.default_rng(K + 1)
    C = 5
    d = _descs(rng, C, K)
    m = rng.random((C, K)) >= p_mask
    pairs = np.array([(a, b) for a in range(C) for b in range(C) if a != b], np.int32)
    got, _ = tp.match_pairs_swapped_plain(torch.from_numpy(d), torch.from_numpy(m), pairs,
                                          ratio=0.85, per_block=3)
    ref = jm.match_pairs_float(d, m, pairs, ratio=0.85)
    near = pair_near_ties(torch.from_numpy(d), torch.from_numpy(m), pairs, 0.85, 1e-6).numpy()
    score, ridx, rvalid = (np.asarray(x) for x in (ref.score, ref.idx, ref.valid))
    assert np.abs(got.score.numpy() - score).max() <= 1e-6
    clear = ~near
    assert np.array_equal(got.valid.numpy()[clear], rvalid[clear])
    acc = clear & rvalid
    assert np.array_equal(got.idx.numpy()[acc], ridx[acc])
    assert int(rvalid.sum()) > 100
    assert np.all(got.score.numpy()[~m[pairs[:, 0]]] == NEG_INF)
