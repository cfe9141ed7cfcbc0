"""Retrieval-quality metrics on the port (``retrieval_scores``,
``recall_at_k``, ``strict_recall_at_k``), mirroring the recall cases of
tests/test_retrieve.py with the keyframe descriptors as tensors, and held
to ``sfmx.localize.retrieve`` on the same inputs: the recalls are host
numpy on both sides, so they are equal; the GEMV scores within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.localize import retrieve as jret
from sfmx_torch.localize import retrieve


def _ring(rng, C=256, Q=32, D=16, correlated=True):
    th = np.linspace(0, 2 * np.pi, C, endpoint=False)
    kfc = np.stack([np.cos(th), np.sin(th), 0 * th], 1).astype(np.float32)
    if correlated:
        g = np.concatenate([kfc[:, :2], 0.05 * rng.standard_normal((C, D - 2))],
                           1).astype(np.float32)
    else:
        g = rng.standard_normal((C, D)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    qi = rng.integers(0, C, Q)
    return kfc, g, qi


def test_recall_at_k_metric():
    """Position-correlated descriptors score ~1.0, random ones near chance;
    the dense-spacing radius counts a same-spot neighbour as a hit."""
    rng = np.random.default_rng(0)
    kfc, g, qi = _ring(rng)
    C, Q, D = 256, 32, 16
    qc = kfc[qi] + 0.001 * rng.standard_normal((Q, 3)).astype(np.float32)
    qg = g[qi] + 0.02 * rng.standard_normal((Q, D)).astype(np.float32)
    qg /= np.linalg.norm(qg, axis=1, keepdims=True)
    alive = np.ones(C, bool)
    r_good = retrieve.recall_at_k(torch.from_numpy(g), torch.from_numpy(kfc),
                                  torch.from_numpy(alive), qg, qc, k=8)
    assert r_good >= 0.95, r_good
    assert r_good == jret.recall_at_k(g, kfc, alive, qg, qc, k=8)
    g_rand = rng.standard_normal((C, D)).astype(np.float32)
    g_rand /= np.linalg.norm(g_rand, axis=1, keepdims=True)
    r_bad = retrieve.recall_at_k(torch.from_numpy(g_rand), kfc, alive, qg, qc, k=8)
    assert r_bad < 0.7, r_bad
    assert r_bad == jret.recall_at_k(g_rand, kfc, alive, qg, qc, k=8)


def test_strict_recall_at_k_metric():
    """The nearest keyframe must be in top-k: exact query descriptors hit
    1.0, random ones sit near chance (k/C)."""
    rng = np.random.default_rng(1)
    kfc, g, qi = _ring(rng, correlated=False)
    C, Q, D = 256, 32, 16
    qc = kfc[qi] + 1e-4 * rng.standard_normal((Q, 3)).astype(np.float32)
    alive = np.ones(C, bool)
    assert retrieve.strict_recall_at_k(torch.from_numpy(g), kfc, alive, g[qi], qc, k=8) == 1.0
    qg_rand = rng.standard_normal((Q, D)).astype(np.float32)
    qg_rand /= np.linalg.norm(qg_rand, axis=1, keepdims=True)
    r_rand = retrieve.strict_recall_at_k(g, kfc, alive, qg_rand, qc, k=8)
    assert r_rand < 0.3, r_rand
    assert r_rand == jret.strict_recall_at_k(g, kfc, alive, qg_rand, qc, k=8)


@pytest.mark.parametrize("radius", [None, 0.05])
def test_recalls_match_reference_with_dead_keyframes(radius):
    """Dead keyframes never count; a fixed radius and a subsampled spacing
    estimate (> 4096 keyframes) take the reference's branches."""
    rng = np.random.default_rng(2)
    C, Q, D = 4500, 24, 16
    kfc, g, qi = _ring(rng, C=C, Q=Q, D=D)
    alive = rng.random(C) > 0.2
    qc = kfc[qi] + 0.002 * rng.standard_normal((Q, 3)).astype(np.float32)
    qg = g[qi] + 0.05 * rng.standard_normal((Q, D)).astype(np.float32)
    got = retrieve.recall_at_k(torch.from_numpy(g), kfc, torch.from_numpy(alive), qg, qc,
                               k=4, radius=radius)
    assert got == jret.recall_at_k(g, kfc, alive, qg, qc, k=4, radius=radius)
    assert (retrieve.strict_recall_at_k(g, kfc, alive, qg, qc, k=4)
            == jret.strict_recall_at_k(g, kfc, alive, qg, qc, k=4))


def test_retrieval_scores_match_reference():
    rng = np.random.default_rng(3)
    kf = rng.standard_normal((40, 64 * 8)).astype(np.float32)
    q = rng.standard_normal(64 * 8).astype(np.float32)
    got = retrieve.retrieval_scores(torch.from_numpy(kf), torch.from_numpy(q)).numpy()
    want = np.asarray(jret.retrieval_scores(jnp.asarray(kf), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
