"""sfmx_torch localization parity: PnP, RANSAC sampling, retrieval, the map
store and ``localize_query``/``localize_batch`` — the same numpy inputs (and
the reference's own RANSAC noise, injected) through ``sfmx`` and the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.cli import config as jcfg
from sfmx.localize import retrieve as jret
from sfmx.localize.localize import LocalizationMap as JMap
from sfmx.localize.localize import build_localization_map as jbuild
from sfmx.localize.localize import localize_batch as jlocalize_batch
from sfmx.localize.localize import localize_batch_streaming as jlocalize_streaming
from sfmx.localize.localize import localize_query as jlocalize_query
from sfmx.mapstore import lmap_store as jstore
from sfmx.mapstore.scene import new_scene
from sfmx.solvers import pnp as jpnp
from sfmx.solvers import ransac as jransac
from sfmx_torch.bench import tripwire_case
from sfmx_torch.cli import config as tcfg
from sfmx_torch.cli.main import localize_images
from sfmx_torch.localize import retrieve as tret
from sfmx_torch.localize.localize import LocalizationMap, build_localization_map
from sfmx_torch.localize.localize import (localize_batch, localize_batch_streaming,
                                          localize_query, localize_query_streaming,
                                          use_streaming)
from sfmx_torch.mapstore import lmap_store as tstore
from sfmx_torch.solvers import pnp as tpnp
from sfmx_torch.solvers import ransac as transac

torch.set_num_threads(2)
INTR = np.array([560.0, 560.0, 320.0, 240.0, 0, 0, 0], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _pose(rng):
    w = (0.2 * rng.normal(size=3)).astype(np.float32)
    from sfmx.core import se3

    return (np.asarray(se3.so3_exp(jnp.asarray(w))),
            np.array([0.2, -0.1, 0.5], np.float32) + 0.1 * rng.normal(size=3).astype(np.float32))


def _correspondences(rng, n, R, t, noise=0.0):
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, (n, 1))], 1).astype(np.float32)
    Xc = X @ R.T + t
    xn = (Xc[:, :2] / Xc[:, 2:] + noise * rng.normal(size=(n, 2))).astype(np.float32)
    return xn, X


def test_dlt_pnp_matches_reference(rng):
    """Batched DLT on 50 noisy correspondences with some masked out: R, t
    within atol 1e-4 of the reference and of the truth's neighbourhood.
    (Single minimal samples are a poor parity probe: their near-singular
    12x12 systems break Cholesky in f32 on either side at random, which
    RANSAC scoring absorbs; the localize tests cover that path end to end.)"""
    R, t = _pose(rng)
    xs, Xs = zip(*[_correspondences(rng, 50, R, t, noise=1e-3) for _ in range(8)])
    xn, X = np.stack(xs), np.stack(Xs)
    mask = rng.random((8, 50)) > 0.2
    Rr, tr = jax.vmap(jpnp.dlt_pnp)(jnp.asarray(xn), jnp.asarray(X), jnp.asarray(mask))
    Rp, tp = tpnp.dlt_pnp(T(xn), T(X), T(mask))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=1e-4)
    np.testing.assert_allclose(Rp.numpy(), np.broadcast_to(R, (8, 3, 3)), atol=2e-2)


def test_refine_pnp_gn_matches_reference(rng):
    """10 GN steps with the accept-if-better rule from a perturbed start,
    outliers masked out: atol 1e-5."""
    R, t = _pose(rng)
    xn, X = _correspondences(rng, 80, R, t, noise=2e-3)
    mask = rng.random(80) > 0.2
    xn[~mask] += 0.3
    from sfmx.core import se3

    R0 = np.asarray(se3.so3_exp(jnp.asarray([0.03, -0.02, 0.01], jnp.float32))) @ R
    t0 = t + np.float32(0.05)
    Rr, tr = jpnp.refine_pnp_gn(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(xn),
                                jnp.asarray(X), jnp.asarray(mask))
    Rp, tp = tpnp.refine_pnp_gn(T(R0), T(t0), T(xn), T(X), T(mask))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=1e-5)
    res = tpnp.pnp_residual(Rp, tp, T(xn), T(X)).numpy()
    np.testing.assert_allclose(res, np.asarray(jpnp.pnp_residual(Rr, tr, jnp.asarray(xn),
                                                                jnp.asarray(X))), atol=1e-5)


@pytest.mark.parametrize("n_valid", [40, 4])
def test_sample_minimal_matches_reference(n_valid):
    """Gumbel-top-k with the reference's noise: identical indices, including
    the tie order among masked slots when fewer than 6 are valid."""
    key = jax.random.PRNGKey(11)
    n, k = 60, 128
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(2).permutation(n)[:n_valid]] = True
    ref = np.asarray(jransac.sample_minimal(key, jnp.asarray(mask), k, 6))
    g = np.asarray(jax.random.gumbel(key, (k, n)))
    out = transac.sample_minimal(T(g), T(mask), 6).numpy()
    np.testing.assert_array_equal(out, ref)


def test_vocabulary_and_vlad_match_reference(rng):
    """k-means with the reference's first seed index, and batched VLAD with
    masked rows: atol 1e-5."""
    desc = rng.normal(size=(400, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    mask = rng.random(400) > 0.1
    key = jax.random.PRNGKey(5)
    first = int(jax.random.choice(key, 400, p=jnp.asarray(mask, jnp.float32) / mask.sum()))
    ref = np.asarray(jret.build_vocabulary(jnp.asarray(desc), jnp.asarray(mask), key, n_words=8))
    vocab = tret.build_vocabulary(T(desc), T(mask), first, n_words=8)
    np.testing.assert_allclose(vocab.numpy(), ref, atol=1e-5)
    q = desc[:300].reshape(3, 100, 32)
    qm = mask[:300].reshape(3, 100)
    ref_v = np.asarray(jret.vlad_encode_b(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(ref)))
    np.testing.assert_allclose(tret.vlad_encode(T(q), T(qm), T(ref)).numpy(), ref_v, atol=1e-5)


def _tripwire_like_map(rng, P=2048, C=16, Kc=128, D=128, vlad=True):
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 8, P)
    lm = rng.standard_normal((P, D)).astype(np.float32)
    lm /= np.linalg.norm(lm, axis=1, keepdims=True)
    kf_lm = rng.permutation(P)[:C * Kc].reshape(C, Kc).astype(np.int32)
    vocab = None
    if vlad:
        vocab = np.asarray(jret.build_vocabulary(jnp.asarray(lm), jnp.ones(P, bool),
                                                 jax.random.PRNGKey(0), n_words=8))
        kf_g = np.asarray(jret.vlad_encode_b(jnp.asarray(lm[kf_lm]), jnp.ones((C, Kc), bool),
                                             jnp.asarray(vocab)))
    else:
        kf_g = lm[kf_lm].mean(1)
        kf_g /= np.linalg.norm(kf_g, axis=1, keepdims=True)
    cols = dict(X=X, lm_desc=lm, lm_alive=rng.random(P) > 0.02, kf_gdesc=kf_g,
                kf_alive=np.ones(C, bool), kf_centers=rng.uniform(-2, 2, (C, 3)).astype(np.float32),
                kf_lm=kf_lm, kf_lm_mask=rng.random((C, Kc)) > 0.05)
    if vocab is not None:
        cols["vocab"] = vocab
    return cols


def _queries(rng, cols, B, K, focals=None):
    """B queries of K keypoints: landmarks of two keyframes each, seen from
    a shifted camera of focal length ``focals[b]`` (560 by default), with 40
    outlier pixels and 10 masked slots."""
    X, lm, kf_lm = cols["X"], cols["lm_desc"], cols["kf_lm"]
    focals = [560.0] * B if focals is None else focals
    q_desc = np.zeros((B, K, lm.shape[1]), np.float32)
    q_uv = np.zeros((B, K, 2), np.float32)
    for b in range(B):
        sel = kf_lm[2 * b:2 * b + 2].reshape(-1)[:K]
        q = lm[sel] + 0.02 * rng.standard_normal((K, lm.shape[1]))
        q_desc[b] = q / np.linalg.norm(q, axis=1, keepdims=True)
        Xc = X[sel] + np.array([0.1 * b, 0.05, 0.2], np.float32)
        f = focals[b]
        q_uv[b] = np.stack([f * Xc[:, 0] / Xc[:, 2] + 320, f * Xc[:, 1] / Xc[:, 2] + 240], 1)
        q_uv[b] += rng.normal(0, 0.5, (K, 2))
    q_uv[:, :40] = rng.uniform(0, 640, (B, 40, 2))       # outliers
    q_mask = np.ones((B, K), bool)
    q_mask[:, -10:] = False
    return q_desc, q_uv, q_mask


@pytest.mark.parametrize("vlad,prior", [(True, False), (False, False), (True, True)])
def test_localize_batch_matches_reference(vlad, prior):
    """Gather path with the reference's RANSAC noise injected: n_inliers
    equal, R and t within atol 1e-4, confidence within 1e-6."""
    rng = np.random.default_rng(42)
    cols = _tripwire_like_map(rng, vlad=vlad)
    B, K, kh = 3, 256, 256
    q_desc, q_uv, q_mask = _queries(rng, cols, B, K)
    key = jax.random.PRNGKey(3)
    gum = np.stack([np.asarray(jax.random.gumbel(k_, (kh, K)))
                    for k_ in jax.random.split(key, B)])
    kw = dict(k_hypotheses=kh, m_cap=512, top_k_kf=4)
    if prior:
        kw.update(prior_center=np.array([0.5, 0.0, 0.0], np.float32), prior_radius=2.5)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    ref = jlocalize_batch(jmap, jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask),
                          jnp.asarray(INTR), key,
                          **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
    tmap = LocalizationMap.from_numpy(cols, "cpu")
    out = localize_batch(tmap, T(q_desc), T(q_uv), T(q_mask), T(INTR), gumbel=T(gum),
                         **{k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    np.testing.assert_array_equal(out.n_inliers.numpy(), np.asarray(ref.n_inliers))
    assert (out.n_inliers.numpy() > 100).all() or prior
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(out.center.numpy(), np.asarray(ref.center), atol=1e-4)
    np.testing.assert_allclose(out.confidence.numpy(), np.asarray(ref.confidence), atol=1e-6)


def test_localize_query_matches_reference():
    """Single-query entry with injected noise: n_inliers equal, pose atol 1e-4."""
    rng = np.random.default_rng(7)
    cols = _tripwire_like_map(rng)
    q_desc, q_uv, q_mask = _queries(rng, cols, 1, 256)
    key = jax.random.PRNGKey(9)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    ref = jlocalize_query(jmap, jnp.asarray(q_desc[0]), jnp.asarray(q_uv[0]),
                          jnp.asarray(q_mask[0]), jnp.asarray(INTR), key,
                          k_hypotheses=128, m_cap=512)
    gum = np.asarray(jax.random.gumbel(key, (128, 256)))
    out = localize_query(LocalizationMap.from_numpy(cols, "cpu"), T(q_desc[0]), T(q_uv[0]),
                         T(q_mask[0]), T(INTR), gumbel=T(gum), k_hypotheses=128, m_cap=512)
    assert int(out.n_inliers) == int(ref.n_inliers) > 100
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)


def _jax_scene(rng, C=6, K=40, D=32):
    """A small sfmx Scene whose landmarks are each observed 1-3 times."""
    P = 120
    obs_cam, obs_pt, obs_feat = [], [], []
    for p in range(P):
        for c in rng.choice(C, rng.integers(1, 4), replace=False):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_feat.append(rng.integers(0, K))
    O = len(obs_cam)
    scene = new_scene(C, P, O, np.asarray([INTR]))
    R = np.stack([np.eye(3, dtype=np.float32)] * C)
    t = rng.normal(size=(C, 3)).astype(np.float32)
    alive = np.ones(O, bool)
    alive[::17] = False
    scene = dataclasses.replace(
        scene, cam_R=jnp.asarray(R), cam_t=jnp.asarray(t), cam_alive=jnp.ones(C, bool),
        X=jnp.asarray(rng.normal(size=(P, 3)), jnp.float32), X_alive=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam, jnp.int32), obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_alive=jnp.asarray(alive))
    desc = rng.normal(size=(C, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return scene, desc, np.asarray(obs_feat, np.int32)


def test_build_localization_map_matches_reference(rng):
    """Landmark pooling, VLAD vocabulary (reference's first seed injected)
    and keyframe lists: columns equal, floats atol 1e-5."""
    scene, desc, obs_feat = _jax_scene(rng)
    ref = jbuild(scene, desc, obs_feat, kf_lm_cap=16, n_words=8, seed=0)
    lm_desc = np.zeros((scene.X.shape[0], desc.shape[-1]), np.float32)
    alive = np.asarray(scene.obs_alive)
    np.add.at(lm_desc, np.asarray(scene.obs_pt)[alive],
              desc[np.asarray(scene.obs_cam)[alive], obs_feat[alive]])
    n_valid = int((np.linalg.norm(lm_desc, axis=1) > 0).sum())
    first = int(jax.random.choice(jax.random.PRNGKey(0), n_valid,
                                  p=jnp.ones(n_valid) / n_valid))
    cols = {f.name: np.asarray(getattr(scene, f.name)) for f in dataclasses.fields(scene)}
    out = build_localization_map(cols, desc, obs_feat, "cpu", kf_lm_cap=16, n_words=8,
                                 vocab_first=first).to_numpy()
    assert ref.lm_bits is None and set(out) == set(JMap._fields) - {"lm_bits"}
    for k in out:
        r = np.asarray(getattr(ref, k))
        if r.dtype.kind == "f":
            np.testing.assert_allclose(out[k], r, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], r, err_msg=k)


def test_lmap_store_roundtrip_both_directions(tmp_path):
    """sfmx saves an .lmap and the port loads it (and the port's save loads
    back in sfmx): every column bit-identical, uint32 bits included."""
    rng = np.random.default_rng(3)
    cols = _tripwire_like_map(rng, P=256, C=8, Kc=32)
    cols["lm_bits"] = rng.integers(0, 2 ** 32, (256, 16), dtype=np.uint64).astype(np.uint32)
    jstore.save_localization_map(tmp_path / "a.lmap", JMap(**{k: jnp.asarray(v)
                                                               for k, v in cols.items()}))
    assert tstore.has_localization_map(tmp_path / "a.lmap")
    tmap = tstore.load_localization_map(tmp_path / "a.lmap", "cpu")
    assert tmap.lm_bits.dtype == torch.int32 and tmap.kf_lm.dtype == torch.int64
    for k, v in tmap.to_numpy().items():
        np.testing.assert_array_equal(v, cols[k], err_msg=k)
    tstore.save_localization_map(tmp_path / "b.lmap", tmap)
    back = jstore.load_localization_map(tmp_path / "b.lmap")
    for k in cols:
        a = np.asarray(getattr(back, k))
        assert a.dtype == cols[k].dtype, k
        np.testing.assert_array_equal(a, cols[k], err_msg=k)
    assert not tstore.has_localization_map(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        tstore.load_localization_map(tmp_path / "missing", "cpu")


def test_config_defaults_match_reference():
    """Same defaults field by field (the port's PipelineConfig has no recon)."""
    for name in ("FeatureConfig", "MatchConfig", "LocalizeConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == \
            dataclasses.asdict(getattr(jcfg, name)()), name
    a, b = tcfg.PipelineConfig(), jcfg.PipelineConfig()
    assert (a.resize_to, a.focal_factor) == (b.resize_to, b.focal_factor)
    ov = ["localize.k_hypotheses=256", "features.sigma_levels=2,3", "localize.binary=true"]
    for sub in ("localize", "features", "match"):
        assert dataclasses.asdict(getattr(tcfg.load_config(None, ov), sub)) == \
            dataclasses.asdict(getattr(jcfg.load_config(None, ov), sub)), sub


def test_streaming_policy_takes_streaming_not_gather(monkeypatch):
    """use_streaming matches the reference's policy, and where it says yes
    ``localize_images`` takes the streaming path (kernel K4's entry) and
    never quietly falls back to the gather path: the gather entry is
    replaced by one that raises."""
    cols = _tripwire_like_map(np.random.default_rng(1), P=512, C=4, Kc=64, vlad=False)
    tmap = LocalizationMap.from_numpy(cols, "cpu")
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    from sfmx.localize.localize import use_streaming as juse

    for mode, thr, binary in [("auto", 65536, False), ("auto", 256, False), ("on", 65536, True),
                              ("off", 1, False), ("on", 65536, False)]:
        lc = tcfg.LocalizeConfig(streaming=mode, streaming_min_landmarks=thr)
        jlc = jcfg.LocalizeConfig(streaming=mode, streaming_min_landmarks=thr)
        assert use_streaming(lc, tmap, binary) == juse(jlc, jmap, binary)
    import sfmx_torch.cli.main as tmain

    calls, orig = [], tmain.localize_batch_streaming

    def streaming(*a, **kw):
        calls.append(kw["ratio"])
        return orig(*a, **kw)

    def gather(*a, **kw):
        raise AssertionError("gather path taken where use_streaming says yes")

    monkeypatch.setattr(tmain, "localize_batch_streaming", streaming)
    monkeypatch.setattr(tmain, "localize_batch", gather)
    cfg = tcfg.load_config(None, ["localize.streaming_min_landmarks=256",
                                  "localize.k_hypotheses=64", "features.max_keypoints=64"])
    out = localize_images(np.zeros((1, 64, 64), np.float32), INTR, tmap, cfg)
    assert calls == [cfg.match.ratio] and len(out) == 1


def test_tripwire_gates_on_cpu():
    """bench.py's gather-path tripwire gates, on the port (CPU): >= K/2
    inliers, |t| < 0.05, |R - I| < 0.02."""
    cols, q_desc, q_uv, intr = tripwire_case()
    K = len(q_uv)
    res = localize_query(LocalizationMap.from_numpy(cols, "cpu"), T(q_desc), T(q_uv),
                         T(np.ones(K, bool)), T(intr),
                         generator=torch.Generator().manual_seed(7),
                         top_k_kf=8, m_cap=2048, k_hypotheses=512)
    assert int(res.n_inliers) >= K // 2 and float(res.confidence) > 0.5
    assert float(torch.linalg.vector_norm(res.t)) < 0.05
    assert float(torch.linalg.matrix_norm(res.R - torch.eye(3))) < 0.02


def _gumbel(key, B, kh, K):
    """The reference's per-query RANSAC noise of a batch call with ``key``."""
    return np.stack([np.asarray(jax.random.gumbel(k_, (kh, K)))
                     for k_ in jax.random.split(key, B)])


def _assert_same_poses(out, ref, atol=1e-4):
    np.testing.assert_array_equal(out.n_inliers.numpy(), np.asarray(ref.n_inliers))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=atol)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=atol)
    np.testing.assert_allclose(out.center.numpy(), np.asarray(ref.center), atol=atol)
    np.testing.assert_allclose(out.confidence.numpy(), np.asarray(ref.confidence), atol=1e-6)


def test_per_query_focal_lengths_in_one_batch():
    """Two queries of one batch with different focal lengths (560 and 700):
    the gather path with (B,7) intrinsics against the reference's
    per-query localize_query (as its server vmaps it), noise injected —
    n_inliers equal, pose atol 1e-4; each inlier threshold follows its own
    focal, so shared intrinsics give a different answer."""
    rng = np.random.default_rng(5)
    cols = _tripwire_like_map(rng)
    B, K, kh = 2, 256, 256
    q_desc, q_uv, q_mask = _queries(rng, cols, B, K, focals=[560.0, 700.0])
    intr_b = np.stack([INTR, INTR]).copy()
    intr_b[1, :2] = 700.0
    key = jax.random.PRNGKey(8)
    gum = _gumbel(key, B, kh, K)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    refs = [jlocalize_query(jmap, jnp.asarray(q_desc[b]), jnp.asarray(q_uv[b]),
                            jnp.asarray(q_mask[b]), jnp.asarray(intr_b[b]), k_,
                            k_hypotheses=kh, m_cap=512, top_k_kf=4)
            for b, k_ in enumerate(jax.random.split(key, B))]
    ref = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *refs)
    tmap = LocalizationMap.from_numpy(cols, "cpu")
    out = localize_batch(tmap, T(q_desc), T(q_uv), T(q_mask), T(intr_b), gumbel=T(gum),
                         k_hypotheses=kh, m_cap=512, top_k_kf=4)
    _assert_same_poses(out, ref)
    assert (out.n_inliers.numpy() > 100).all()
    shared = localize_batch(tmap, T(q_desc), T(q_uv), T(q_mask), T(INTR), gumbel=T(gum),
                            k_hypotheses=kh, m_cap=512, top_k_kf=4)
    assert int(shared.n_inliers[1]) < int(out.n_inliers[1])
    with pytest.raises(ValueError):
        localize_batch(tmap, T(q_desc), T(q_uv), T(q_mask), T(intr_b[:, :6]), gumbel=T(gum),
                       k_hypotheses=kh)


@pytest.mark.parametrize("case", ["shared", "prior", "per_query_intr"])
def test_localize_batch_streaming_matches_reference(case):
    """The streaming path (whole pool, plain K4 here, the Pallas kernel in
    interpret mode there) with the reference's RANSAC noise injected:
    n_inliers equal, pose atol 1e-4; also with a beacon prior that zeroes
    the landmarks outside its radius, and with (B,7) intrinsics whose
    focal lengths differ within the batch."""
    rng = np.random.default_rng(11)
    cols = _tripwire_like_map(rng, vlad=False)
    B, K, kh = 3, 256, 256
    focals = [560.0, 640.0, 560.0] if case == "per_query_intr" else None
    q_desc, q_uv, q_mask = _queries(rng, cols, B, K, focals=focals)
    intr = INTR
    if case == "per_query_intr":
        intr = np.stack([INTR] * B).copy()
        intr[1, :2] = 640.0
    kw = dict(k_hypotheses=kh, ratio=0.8)
    if case == "prior":
        kw.update(prior_center=np.array([0.0, 0.0, 5.0], np.float32), prior_radius=3.0)
    key = jax.random.PRNGKey(12)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    ref = jlocalize_streaming(jmap, jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask),
                              jnp.asarray(intr), key, interpret=True,
                              **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                 for k, v in kw.items()})
    out = localize_batch_streaming(
        LocalizationMap.from_numpy(cols, "cpu"), T(q_desc), T(q_uv), T(q_mask), T(intr),
        gumbel=T(_gumbel(key, B, kh, K)),
        **{k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    _assert_same_poses(out, ref)
    assert (out.n_inliers.numpy() > 50).all()


def test_localize_query_streaming_matches_batch_entry():
    """The single-query entry equals row 0 of the batch entry (same noise)."""
    rng = np.random.default_rng(2)
    cols = _tripwire_like_map(rng, P=1024, C=8, vlad=False)
    q_desc, q_uv, q_mask = _queries(rng, cols, 1, 256)
    g = transac.gumbel_noise((1, 128, 256), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    tmap = LocalizationMap.from_numpy(cols, "cpu")
    one = localize_query_streaming(tmap, T(q_desc[0]), T(q_uv[0]), T(q_mask[0]), T(INTR),
                                   gumbel=g[0], k_hypotheses=128)
    batch = localize_batch_streaming(tmap, T(q_desc), T(q_uv), T(q_mask), T(INTR), gumbel=g,
                                     k_hypotheses=128)
    assert int(one.n_inliers) == int(batch.n_inliers[0]) > 50
    torch.testing.assert_close(one.R, batch.R[0])


def test_binary_localize_batch_matches_reference(rng):
    """Hamming 2D-3D matching on packed bits (the query's bits are its
    landmarks' with ~8% of the bits flipped), retrieval on float VLAD,
    noise injected: n_inliers equal, pose atol 1e-4; the map's bits come
    from build_localization_map(feat_bits=...) on both sides."""
    cols = _tripwire_like_map(rng)
    P = len(cols["X"])
    bits = rng.integers(0, 2 ** 32, (P, 16), dtype=np.uint64).astype(np.uint32)
    cols["lm_bits"] = bits
    B, K, kh = 2, 256, 256
    q_desc, q_uv, q_mask = _queries(rng, cols, B, K)
    q_bits = np.zeros((B, K, 16), np.uint32)
    for b in range(B):
        sel = cols["kf_lm"][2 * b:2 * b + 2].reshape(-1)[:K]
        flips = (rng.random((K, 16, 32)) < 0.08).astype(np.uint32)
        q_bits[b] = bits[sel] ^ np.sum(flips << np.arange(32, dtype=np.uint32), axis=-1,
                                        dtype=np.uint32)
    key = jax.random.PRNGKey(21)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()})
    kw = dict(k_hypotheses=kh, m_cap=512, top_k_kf=4, ham_thresh=120.0)
    ref = jlocalize_batch(jmap, jnp.asarray(q_desc), jnp.asarray(q_uv), jnp.asarray(q_mask),
                          jnp.asarray(INTR), key, q_bits=jnp.asarray(q_bits), **kw)
    tmap = LocalizationMap.from_numpy(cols, "cpu")
    assert tmap.lm_bits.dtype == torch.int32
    out = localize_batch(tmap, T(q_desc), T(q_uv), T(q_mask), T(INTR),
                         gumbel=T(_gumbel(key, B, kh, K)), q_bits=T(q_bits.view(np.int32)), **kw)
    _assert_same_poses(out, ref)
    assert (out.n_inliers.numpy() > 100).all()


def test_build_localization_map_with_bits_matches_reference(rng):
    """feat_bits -> lm_bits by majority vote: the same words as the
    reference's map, and the store keeps them as uint32."""
    scene, desc, obs_feat = _jax_scene(rng)
    bits = rng.integers(0, 2 ** 32, desc.shape[:2] + (16,), dtype=np.uint64).astype(np.uint32)
    ref = jbuild(scene, desc, obs_feat, kf_lm_cap=16, use_vlad=False, feat_bits=bits)
    cols = {f.name: np.asarray(getattr(scene, f.name)) for f in dataclasses.fields(scene)}
    out = build_localization_map(cols, desc, obs_feat, "cpu", kf_lm_cap=16, use_vlad=False,
                                 feat_bits=bits.view(np.int32))
    np.testing.assert_array_equal(out.to_numpy()["lm_bits"], np.asarray(ref.lm_bits))
