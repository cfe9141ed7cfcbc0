"""K4 and the matching helpers: the port's plain ``match_top2`` against the
Pallas kernel in interpret mode and its jnp oracle, the streaming matcher,
the Hamming distance and the landmark majority vote — the same numpy inputs
through ``sfmx`` and the port.  The CUDA kernel's own checks are in
test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.kernels import matching as jmatching
from sfmx.kernels.pallas_match import match_float_streaming as jstream
from sfmx.kernels.pallas_match import match_top2 as jtop2
from sfmx.kernels.pallas_match import match_top2_reference as jtop2_ref
from sfmx.localize.localize import _majority_bits as jmajority
from sfmx_torch.kernels import match as tmatch
from sfmx_torch.kernels import matching as tmatching
from sfmx_torch.localize.localize import _majority_bits as tmajority

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def unit_rows(rng, n, d=128):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _planted(rng, Ka, Kb, pad_b):
    """Queries and a pool with exact duplicates across tile boundaries (ties:
    the lower index wins and s2 == s1), a zeroed (masked) query row and a
    pool zero-padded by ``pad_b`` rows, as match_float_streaming pads it."""
    a, b = unit_rows(rng, Ka), unit_rows(rng, Kb)
    b[Kb - 3] = b[5]
    b[70] = a[3] + 0.01 * rng.standard_normal(128).astype(np.float32)
    b[70] /= np.linalg.norm(b[70])
    a[4] = b[5]
    a[6] = 0.0
    return a, np.pad(b, ((0, pad_b), (0, 0)))


@pytest.mark.parametrize("Ka,Kb,pad_b", [(64, 200, 56), (96, 130, 62)])
def test_match_top2_plain_matches_pallas_and_reference(rng, Ka, Kb, pad_b):
    """Plain K4 (landmark chunks of 37 columns, so the running merge crosses
    chunk borders inside ties) against the Pallas kernel in interpret mode
    (tile_b 64) and the jnp oracle: s1/s2 atol 1e-6, indices equal, the
    duplicate keeps its lower index with s2 == s1, the zero row scores 0 and
    the padded rows can win it (index >= Kb)."""
    a, b = _planted(rng, Ka, Kb, pad_b)
    s1, i1, s2 = (np.asarray(x) for x in jtop2(jnp.asarray(a), jnp.asarray(b),
                                                tile_a=32, tile_b=64, interpret=True))
    r1, j1, r2 = (np.asarray(x) for x in jtop2_ref(jnp.asarray(a), jnp.asarray(b)))
    out = tmatch.match_top2_plain(T(a), T(b), max_elems=37 * Ka)
    ref = tmatch.match_top2_reference(T(a), T(b))
    for o1, oi, o2 in (out, ref):
        np.testing.assert_allclose(o1.numpy(), s1, atol=1e-6)
        np.testing.assert_allclose(o2.numpy(), s2, atol=1e-6)
        np.testing.assert_array_equal(oi.numpy(), i1)
    np.testing.assert_array_equal(j1, i1)
    np.testing.assert_allclose(r2, s2, atol=1e-6)
    assert int(out[1][4]) == 5 and float(out[0][4]) == float(out[2][4])
    assert int(out[1][3]) == 70
    assert float(out[0][6]) == 0.0 and float(out[2][6]) == 0.0
    # the wrapper takes its plain version for CPU tensors and checks tiles
    w = tmatch.match_top2(T(a), T(b), tile_a=32, tile_b=64)
    np.testing.assert_array_equal(w[1].numpy(), i1)
    with pytest.raises(ValueError):
        tmatch.match_top2(T(a), T(b[:-1]), tile_a=32, tile_b=64)


@pytest.mark.parametrize("ratio", [0.8, 0.85])
def test_match_float_streaming_matches_reference(rng, ratio):
    """Masked rows on both sides and a pool that is not a tile multiple
    (Kb 150, tile_b 64): the accept set, indices and scores of the
    reference's streaming matcher (interpret mode), atol 1e-6 on scores."""
    base = unit_rows(rng, 200)
    Ka, Kb = 96, 150
    da = base[rng.permutation(200)[:Ka]] + 0.05 * rng.standard_normal((Ka, 128))
    da = (da / np.linalg.norm(da, axis=1, keepdims=True)).astype(np.float32)
    db = base[rng.permutation(200)[:Kb]]
    ma, mb = rng.random(Ka) > 0.1, rng.random(Kb) > 0.1
    ref = jstream(jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
                  ratio=ratio, tile_a=32, tile_b=64, interpret=True)
    out = tmatch.match_float_streaming(T(da), T(db), T(ma), T(mb), ratio=ratio,
                                       tile_a=32, tile_b=64)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score), atol=1e-6)
    assert 20 < int(out.valid.sum()) < Ka


def test_hamming_distance_matches_reference(rng):
    """Random uint32 words with the top bit set in many of them (the int32
    view is negative): distances equal, with and without a batch axis."""
    a = rng.integers(0, 2 ** 32, (2, 9, 16), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (2, 13, 16), dtype=np.uint64).astype(np.uint32)
    b[0, 3] = a[0, 2]
    b[1, 0] = ~a[1, 0]
    out = tmatching.hamming_distance(T(a.view(np.int32)), T(b.view(np.int32))).numpy()
    for i in range(2):
        ref = np.asarray(jmatching.hamming_distance(jnp.asarray(a[i]), jnp.asarray(b[i])))
        np.testing.assert_array_equal(out[i], ref)
    assert out[0, 2, 3] == 0 and out[1, 0, 0] == 512
    w = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    np.testing.assert_array_equal(tmatching.popcount32(T(w.view(np.int32))).numpy(),
                                  [0, 1, 32, 1, 31])


def test_majority_bits_matches_reference(rng):
    """Per-landmark majority vote over observation bits, ties to 0, dead
    observations ignored: words equal."""
    C, K, W, P = 4, 20, 16, 30
    bits = rng.integers(0, 2 ** 32, (C, K, W), dtype=np.uint64).astype(np.uint32)
    O = 80
    obs_cam, obs_feat = rng.integers(0, C, O), rng.integers(0, K, O)
    obs_pt = np.concatenate([np.arange(P), rng.integers(0, P, O - P)])
    alive = rng.random(O) > 0.15
    ref = jmajority(bits, obs_cam, obs_feat, obs_pt, alive, P)
    out = tmajority(bits, obs_cam, obs_feat, obs_pt, alive, P)
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out, ref)
