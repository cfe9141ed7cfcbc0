"""Pair matching: the port's matchers (dense float, Hamming, the dispatch,
K5's and K9's wrappers and K10's raw mode, all on their plain versions
here) against ``sfmx``'s dense oracle and its Pallas kernels in interpret
mode, on the same numpy inputs; ``pack_tiles`` against the reference's.
The CUDA kernels' own checks are in test_torch_gpu.py.

Tolerances: scores atol 1e-6 (bf16 products are exact in f32 on both sides;
only the order of the 128-term sums differs between XLA's CPU dot and
torch's matmul); accept sets and winning indices equal outside near-ties
(``smoke_scenes.pair_near_ties`` with tol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching as jm
from sfmx.kernels.pallas_pairs import match_pairs_float_pallas as jfused
from sfmx.kernels.pallas_pairs import match_pairs_top2 as jtop2
from sfmx.kernels.pallas_tiles import match_pairs_float_tiled as jtiled
from sfmx.kernels.pallas_tiles import pack_tiles as jpack
from sfmx_torch.kernels import matching as tm
from sfmx_torch.kernels import pairs as tp
from sfmx_torch.kernels import tiles as tt
from tests.smoke_scenes import pair_near_ties

torch.set_num_threads(2)
TOL = 1e-6


def _descs(rng, C=6, K=256, D=128, planted=64):
    d = rng.standard_normal((C, K, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for c in range(1, C):  # neighbours share noisy copies, so accepts exist
        d[c, :planted] = d[c - 1, :planted] + 0.05 * rng.standard_normal(
            (planted, D)).astype(np.float32)
        d[c] /= np.linalg.norm(d[c], axis=-1, keepdims=True)
    return d


def _correlated_descs(rng, C, K=128, D=128, noise=0.1):
    base = rng.standard_normal((K, D)).astype(np.float32)
    d = np.stack([base + noise * rng.standard_normal((K, D)).astype(np.float32)
                  for _ in range(C)])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _band_pairs(rng, C, w=6, extras=20):
    pairs = {(a, b) for a in range(C) for b in range(a + 1, min(a + 1 + w, C))}
    for _ in range(extras):
        a = int(rng.integers(0, C // 2))
        b = int(rng.integers(C // 2, C))
        pairs.add((min(a, b), max(a, b)))
    return np.array(sorted(pairs), np.int32)


def _assert_same(got, ref, near):
    """score atol TOL; valid equal and idx equal on accepted rows outside
    near-ties."""
    gi, gv, gs = (np.asarray(x) for x in (got.idx, got.valid, got.score))
    ri, rv, rs = (np.asarray(x) for x in (ref.idx, ref.valid, ref.score))
    np.testing.assert_allclose(gs, rs, atol=TOL, rtol=0)
    clear = ~np.asarray(near)
    np.testing.assert_array_equal(gv[clear], rv[clear])
    np.testing.assert_array_equal(gi[clear & rv], ri[clear & rv])


def _near(d, m, pairs, ratio):
    return pair_near_ties(torch.from_numpy(d), torch.from_numpy(m), pairs, ratio, TOL)


@pytest.mark.parametrize("K,p_mask,cross_check,chunk", [
    (256, 0.0, True, 1 << 26), (128, 0.3, True, 128 * 128 * 2), (96, 0.2, False, 96 * 96 * 3)])
def test_match_pairs_float_matches_dense_oracle(rng, monkeypatch, K, p_mask, cross_check, chunk):
    """The port's dense matcher (chunked over pairs: chunks of 2 and 3 pairs
    in the small-chunk cases) against ``sfmx``'s vmapped one, with masks."""
    monkeypatch.setattr(tm, "CHUNK_ELEMS", chunk)
    d = _descs(rng, K=K)
    m = rng.random(d.shape[:2]) >= p_mask
    pairs = np.array([(a, b) for a in range(6) for b in range(a + 1, 6)], np.int32)
    ref = jm.match_pairs_float(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs),
                               ratio=0.85, cross_check=cross_check)
    got = tm.match_pairs_float(torch.from_numpy(d), torch.from_numpy(m), pairs,
                               ratio=0.85, cross_check=cross_check)
    assert np.asarray(ref.valid).sum() > 100
    _assert_same(got, ref, _near(d, m, pairs, 0.85))
    # a masked row keeps the dense convention: score NEG, index 0
    ma = m[pairs[:, 0]]
    assert np.all(got.score.numpy()[~ma] == -1e30) and np.all(got.idx.numpy()[~ma] == 0)


def test_match_float_single_pair_matches_reference(rng):
    """One pair through ``match_float`` (the per-pair entry)."""
    d = _descs(rng, C=2, K=160)
    m = rng.random(d.shape[:2]) > 0.1
    ref = jm.match_float(jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.asarray(m[0]),
                         jnp.asarray(m[1]), ratio=0.8)
    got = tm.match_float(*(torch.from_numpy(x) for x in (d[0], d[1], m[0], m[1])), ratio=0.8)
    near = _near(d, m, np.array([[0, 1]], np.int32), 0.8)[0]
    _assert_same(got, ref, near)
    assert int(got.valid.sum()) > 30


def test_k5_plain_matches_pallas_full_masks(rng):
    """K5's wrapper (plain on the CPU) against the Pallas kernel in interpret
    mode: under full masks the two contracts coincide, so the accept sets
    and the winners are equal."""
    d = _descs(rng)
    m = np.ones(d.shape[:2], bool)
    pairs = np.asarray([[0, 1], [2, 3], [1, 4], [0, 5]], np.int32)
    ref = jfused(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs), ratio=0.85,
                 interpret=True)
    got = tp.match_pairs_fused(torch.from_numpy(d), torch.from_numpy(m), pairs, ratio=0.85)
    assert np.asarray(ref.valid).sum() > 32
    _assert_same(got, ref, _near(d, m, pairs, 0.85))


def test_k5_plain_vs_pallas_partial_masks_conservative(rng):
    """Under partial masks the Pallas kernel is conservative against the
    dense contract the port holds (it takes the column max over masked rows
    too): it accepts only rows the port accepts, with the same winner, and
    nearly all of them; masked query rows are never accepted."""
    d = _descs(rng, C=4)
    m = rng.random(d.shape[:2]) > 0.3
    pairs = np.asarray([[0, 1], [2, 3], [1, 2]], np.int32)
    ref = jfused(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs), ratio=0.85,
                 interpret=True)
    got = tp.match_pairs_fused(torch.from_numpy(d), torch.from_numpy(m), pairs, ratio=0.85)
    pv, tv = np.asarray(ref.valid), got.valid.numpy()
    assert not np.any(pv & ~tv)
    same = pv & tv
    np.testing.assert_array_equal(np.asarray(ref.idx)[same], got.idx.numpy()[same])
    assert same.sum() >= 0.9 * tv.sum() and tv.sum() > 20
    assert not np.any(tv & ~m[pairs[:, 0]])


def test_k10_plain_matches_pallas_top2(rng):
    """K10's plain version against ``match_pairs_top2`` in interpret mode:
    s1/s2 atol 1e-6; i1 where the row's best two columns differ by more than
    1e-6, j1 where the column's best two rows do.  Planted exact duplicates
    (a column, a row) resolve to the lower index."""
    d = _descs(rng, C=4, K=128)
    d[1, 120] = d[1, 7]      # duplicate column of image 1
    d[0, 100] = d[0, 9]      # duplicate row of image 0
    pairs = np.asarray([[0, 1], [2, 3], [0, 2], [3, 1], [1, 0]], np.int32)
    r1, ri, r2, rj = (np.asarray(x) for x in jtop2(jnp.asarray(d), jnp.asarray(pairs),
                                                    interpret=True))
    s1, i1, s2, j1 = (x.numpy() for x in tp.match_pairs_top2(torch.from_numpy(d), pairs))
    np.testing.assert_allclose(s1, r1, atol=TOL, rtol=0)
    np.testing.assert_allclose(s2, r2, atol=TOL, rtol=0)
    np.testing.assert_array_equal(i1[r1 - r2 > TOL], ri[r1 - r2 > TOL])
    sim = np.einsum("pkd,pjd->pkj", *(np.asarray(jnp.asarray(d[pairs[:, i]], jnp.bfloat16),
                                                 np.float32) for i in (0, 1)))
    cs = np.sort(sim, axis=1)
    clear_c = cs[:, -1] - cs[:, -2] > TOL
    np.testing.assert_array_equal(j1[clear_c], rj[clear_c])
    assert not np.any(i1[0] == 120) and not np.any(j1[0] == 100)
    assert i1.dtype == np.int32 and j1.dtype == np.int32


def test_match_pairs_hamming_matches_reference(rng):
    """Batched Hamming matching (plain torch on int32 words) against
    ``sfmx``'s on the same uint32 words: noisy copies match back to their
    source; idx, valid and scores (integer distances) equal."""
    C, K, W = 4, 96, 16
    base = rng.integers(0, 2 ** 32, size=(K, W), dtype=np.uint32)
    bits = np.stack([base ^ (rng.random((K, W, 32)) < 0.03).astype(np.uint32).dot(
        (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)).astype(np.uint32)
        for _ in range(C)])
    m = rng.random((C, K)) > 0.1
    pairs = np.asarray([[0, 1], [1, 2], [0, 3], [2, 3]], np.int32)
    ref = jm.match_pairs_hamming(jnp.asarray(bits), jnp.asarray(m), jnp.asarray(pairs),
                                 ratio=0.8)
    got = tm.match_pairs_hamming(torch.from_numpy(bits.view(np.int32)), torch.from_numpy(m),
                                 pairs, ratio=0.8)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    v = got.valid.numpy()
    assert v.sum() > 200 and np.all(got.idx.numpy()[v] == np.nonzero(v)[1])


@pytest.mark.parametrize("kernel", ["auto", "pallas", "tiles", "dense"])
def test_auto_dispatch_on_cpu_is_the_dense_contract(rng, kernel):
    """On CPU tensors every dispatch choice gives the dense matcher's result
    (the kernel wrappers run their plain versions), as the reference's
    dispatch does on its CPU backend."""
    d = _correlated_descs(rng, 10)
    m = rng.random(d.shape[:2]) > 0.1
    pairs = _band_pairs(rng, 10, w=3, extras=4)
    ref = jm.match_pairs_float_auto(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs),
                                    ratio=0.85, kernel="dense")
    got = tm.match_pairs_float_auto(torch.from_numpy(d), torch.from_numpy(m), pairs,
                                    ratio=0.85, kernel=kernel)
    _assert_same(got, ref, _near(d, m, pairs, 0.85))
    with pytest.raises(ValueError):
        tm.match_pairs_float_auto(torch.from_numpy(d), torch.from_numpy(m), pairs,
                                  kernel="nope")


@pytest.mark.parametrize("C,w,extras,Ta,min_fill", [(40, 9, 10, 8, 8), (24, 6, 20, 8, 8),
                                                    (33, 4, 30, 4, 3), (9, 2, 3, 8, 8)])
def test_pack_tiles_equals_reference(C, w, extras, Ta, min_fill):
    """``pack_tiles`` is a copy: every output equal to the reference's."""
    pairs = _band_pairs(np.random.default_rng(C), C, w=w, extras=extras)
    ref = jpack(pairs, C, Ta=Ta, Tb=Ta, min_fill=min_fill)
    got = tt.pack_tiles(pairs, C, Ta=Ta, Tb=Ta, min_fill=min_fill)
    for r, g in zip(ref, got):
        if r is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_tile_groups_share_the_a_image():
    """K9's work list: every packed pair exactly once; the pairs of a group
    share their a-image, with b ascending, at most Tb of them."""
    C = 40
    pairs = _band_pairs(np.random.default_rng(3), C, w=9, extras=10)
    _, pos, dense_idx, _, _ = tt.pack_tiles(pairs, C)
    slot_pairs, start = tt.tile_groups(pos, dense_idx, 8)
    assert sorted(slot_pairs.tolist()) == sorted(dense_idx.tolist())
    for s, e in zip(start[:-1], start[1:]):
        p = pairs[slot_pairs[s:e]]
        assert 0 < e - s <= 8 and len(set(p[:, 0])) == 1 and np.all(np.diff(p[:, 1]) > 0)


def test_tiled_matches_reference_tiled_and_dense(rng):
    """The tiled wrapper (plain on the CPU: the packed band and the
    leftovers routed separately, outputs back in input order) against the
    reference's tiled matcher in interpret mode (its bf16-packed scores
    within 2e-2, the reference test's bound) and exactly against the dense
    contract."""
    C = 24
    d = _correlated_descs(rng, C)
    m = rng.random(d.shape[:2]) > 0.1
    d = d * m[:, :, None]
    pairs = _band_pairs(rng, C)
    _, _, dense_idx, rest_idx, _ = tt.pack_tiles(pairs, C)
    assert len(dense_idx) > 0 and len(rest_idx) > 0
    ref = jtiled(jnp.asarray(d), jnp.asarray(m), pairs, ratio=0.8, interpret=True)
    got = tt.match_pairs_float_tiled(torch.from_numpy(d), torch.from_numpy(m), pairs,
                                     ratio=0.8)
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    near = _near(d, m, pairs, 0.8).numpy()
    assert rv.sum() > 100
    np.testing.assert_array_equal(gv[~near], rv[~near])
    acc = gv & rv
    np.testing.assert_array_equal(got.idx.numpy()[acc], np.asarray(ref.idx)[acc])
    assert np.allclose(got.score.numpy()[acc], np.asarray(ref.score)[acc], atol=2e-2)
    dense = jm.match_pairs_float(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs), ratio=0.8)
    _assert_same(got, dense, near)


def test_tiled_small_c_routes_to_fused(rng):
    """Fewer images than a tile (C < max(Ta,Tb)) or no pairs go through K5's
    wrapper whole."""
    d = _correlated_descs(rng, 4)
    m = np.ones(d.shape[:2], bool)
    pairs = np.asarray([[0, 1], [1, 2], [2, 3]], np.int32)
    ref = jm.match_pairs_float(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs))
    got = tt.match_pairs_float_tiled(torch.from_numpy(d), torch.from_numpy(m), pairs)
    _assert_same(got, ref, _near(d, m, pairs, 0.8))
    empty = tt.match_pairs_float_tiled(torch.from_numpy(d), torch.from_numpy(m),
                                       np.zeros((0, 2), np.int32))
    assert empty.idx.shape == (0, 128)


def test_match_result_numpy_roundtrip(rng):
    """``MatchResult.from_numpy`` takes the reference's record (idx int32)
    and ``to_numpy`` gives it back."""
    d = _descs(rng, C=3, K=64)
    m = np.ones(d.shape[:2], bool)
    pairs = np.asarray([[0, 1], [1, 2]], np.int32)
    ref = jm.match_pairs_float(jnp.asarray(d), jnp.asarray(m), jnp.asarray(pairs))
    t = tm.MatchResult.from_numpy(ref, "cpu")
    assert t.idx.dtype == torch.int64 and t.valid.dtype == torch.bool
    back = t.to_numpy()
    for x, y in zip(back, ref):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert back.idx.dtype == np.int32
