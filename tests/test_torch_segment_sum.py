"""The fixed-order segment sum of the port's BA (``segment_sum.segment_plan``,
``segment_sum.segment_sum``, a hand-written kernel on the card), which
replaced ``index_add_``: its float atomics on a card made two builds with
one seed differ.  The bits depend only on the rows' order within each
segment: two calls on ids in shuffled order are bit-equal, and moving rows
of different segments around (each segment's own order kept) changes
nothing.  Against ``index_add_`` and the reference's
``jax.ops.segment_sum`` within 1e-5 of the largest sum (f32 order).  The
kernel's order (pieces of at most PIECE_ROWS sorted rows, a warp's 32
strided lane sums, a butterfly, then a segment's pieces in order) is
mirrored in numpy here; the card holds the kernel to the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx_torch.kernels import segment_sum as ss
from sfmx_torch.solvers import lm

from .synthetic import make_scene
from .test_ba import build_obs_table


@pytest.mark.parametrize("shape", [(36,), (6, 3), ()])
def test_segment_sum_order_is_fixed(shape):
    rng = np.random.default_rng(0)
    O, n = 5000, 97
    ids = torch.from_numpy(rng.integers(0, n - 3, O))            # the last 3 segments empty
    x = torch.from_numpy(rng.standard_normal((O, *shape)).astype(np.float32) * 100)
    plan = ss.segment_plan(ids, n)
    a, b = ss.segment_sum(x, plan), ss.segment_sum(x, ss.segment_plan(ids, n))
    assert torch.equal(a, b)
    assert torch.equal(a[-3:], torch.zeros_like(a[-3:]))
    # rows of different segments interleaved otherwise, each segment's order kept
    key = torch.from_numpy(rng.permutation(n))[ids] * O + torch.arange(O)
    perm = torch.argsort(key)
    moved = ss.segment_sum(x[perm], ss.segment_plan(ids[perm], n))
    assert torch.equal(moved, a)
    ref = torch.zeros((n, *shape)).index_add_(0, ids, x)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    jref = np.asarray(jax.ops.segment_sum(jnp.asarray(x.numpy()), jnp.asarray(ids.numpy()),
                                          num_segments=n))
    np.testing.assert_allclose(a.numpy(), jref, rtol=0, atol=1e-5 * scale)


def test_plan_of_sorted_ids():
    """Sorted ids: the identity order, one piece a segment (empty ones too)."""
    ids = torch.tensor([0, 0, 2, 2, 2, 5])
    plan = ss.segment_plan(ids, 7)
    assert plan.perm.tolist() == list(range(6)) and plan.seg_piece is None
    assert plan.lengths.tolist() == [2, 0, 3, 0, 0, 1, 0]
    assert plan.piece_off.tolist() == [0, 2, 2, 5, 5, 5, 6, 6]
    assert ss.segment_plan(ids.flip(0), 7).perm.tolist() == [4, 5, 1, 2, 3, 0]


def _kernel_order(x: np.ndarray, plan) -> np.ndarray:
    """The kernel's order in f32: each piece's rows in lane j's turn (rows
    j, j+32, ... of the piece), the 32 lane sums in a butterfly of xor
    shuffles (16, 8, 4, 2, 1), then a segment's pieces alike."""
    def warp(rows: np.ndarray) -> np.ndarray:
        lanes = np.zeros((32, rows.shape[1]), np.float32)
        for r in range(rows.shape[0]):
            lanes[r % 32] += rows[r]
        for s in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ s]
        return lanes[0]

    srt = x.reshape(x.shape[0], -1)[plan.perm.numpy()]
    off = plan.piece_off.numpy()
    pieces = np.stack([warp(srt[off[i]:off[i + 1]]) for i in range(len(off) - 1)])
    if plan.seg_piece is None:
        return pieces
    sp = plan.seg_piece.numpy()
    return np.stack([warp(pieces[sp[s]:sp[s + 1]]) for s in range(plan.n)])


def test_long_segments_are_summed_in_pieces():
    """A segment of 40,000 rows (an intrinsics group's observations) beside
    short ones: pieces of at most PIECE_ROWS sorted rows covering each
    segment in order, their sums summed per segment; the plain version and
    the kernel's order (mirrored) within 1e-5 of the largest sum of
    ``index_add_``'s in f64."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(np.concatenate([np.zeros(40000, np.int64), rng.integers(1, 9, 500)]))
    ids = ids[torch.from_numpy(rng.permutation(len(ids)))]
    x = torch.from_numpy(rng.standard_normal((len(ids), 4)).astype(np.float32))
    plan = ss.segment_plan(ids, 10)
    off, sp = plan.piece_off.numpy(), plan.seg_piece.numpy()
    assert len(off) - 1 == 20 + 9 and sp.tolist()[:3] == [0, 20, 21]
    assert np.all(np.diff(off) <= ss.PIECE_ROWS) and off[0] == 0 and off[-1] == len(ids)
    bounds = np.concatenate([[0], np.cumsum(plan.lengths.numpy())])
    np.testing.assert_array_equal(off[sp], bounds)             # a segment's pieces tile it
    got = ss.segment_sum(x, plan)
    ref = torch.zeros((10, 4), dtype=torch.float64).index_add_(0, ids, x.double())
    atol = 1e-5 * float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(_kernel_order(x.numpy(), plan), ref.numpy(), rtol=0, atol=atol)
    assert torch.equal(got, ss.segment_sum(x, plan))


def test_kernel_order_on_short_segments():
    """One piece a segment (points' and cameras' sums): the mirrored
    kernel order within 1e-5 of the largest sum of the plain version."""
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 300, 20000))
    x = torch.from_numpy(rng.standard_normal((20000, 6, 3)).astype(np.float32))
    plan = ss.segment_plan(ids, 301)
    assert plan.seg_piece is None
    got = ss.segment_sum(x, plan)
    np.testing.assert_allclose(_kernel_order(x.numpy(), plan).reshape(got.shape), got.numpy(),
                               rtol=0, atol=1e-5 * float(got.abs().max()))


def test_planes_solve_repeats_bit_for_bit():
    """The planes path (every sum on segment plans) twice on one problem
    gives the same bits, and its cost falls to the noise floor."""
    sc = make_scene(n_cams=8, n_points=120, noise_px=0.4)
    cam_id, pt_id, uv, w = build_obs_table(sc)
    rng = np.random.default_rng(1)
    order = rng.permutation(len(cam_id))
    T = torch.as_tensor
    fixed = torch.zeros(8, dtype=torch.bool)
    fixed[0] = True
    args = (T(sc.intrinsics, dtype=torch.float32)[None], torch.zeros(8, dtype=torch.int64),
            T(sc.Rs, dtype=torch.float32), T(sc.ts, dtype=torch.float32),
            T(sc.points + 0.02 * rng.standard_normal(sc.points.shape), dtype=torch.float32),
            T(cam_id[order]), T(pt_id[order]), T(uv[order]), T(w[order]), fixed)
    one = lm.ba_solve(*args, iters=6, cg_iters=20)
    two = lm.ba_solve(*args, iters=6, cg_iters=20)
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    assert float(one[3][-1]) < 0.05 * float(one[3][0])
