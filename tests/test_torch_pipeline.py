"""The map-build front end on the port — stage cache, pair selection,
``match_images``, ``verify_matches`` and tracks — against ``sfmx``'s stage
functions on the same numpy features.

Tolerances: pair lists and cached records compare exactly; matches exactly
on these well-separated synthetic descriptors; verification with the
reference's own per-chunk Gumbel draws injected, inlier masks equal except
where a match's squared Sampson error lies within 1% of the threshold (the
two sides' 9x9 Cholesky and 3x3 SVD round differently there), counts
within the number of such matches; the slice's corrupted-track count and
kept pairs within 2 of the reference's.  ``build_map`` on the same case:
every camera registered, ATE < 0.1 and the reference's scene within 0.05
after a similarity alignment (the two draw different RANSAC samples; the
gates of tests/test_recon_e2e.py); scene stores exchanged with ``sfmx``
compare column by column, exactly.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.cli import pipeline as jp
from sfmx.cli.config import load_config as jload_config
from sfmx.kernels.matching import MatchResult as JMatchResult
from sfmx.recon import tracks as jtracks
from sfmx_torch.cli import pipeline as tp
from sfmx_torch.cli.config import load_config
from sfmx_torch.kernels import matching as tm
from sfmx_torch.kernels.features import Features
from sfmx_torch.recon import tracks as ttracks
from sfmx_torch.utils.logging import LOGGER
from tests.synthetic import make_scene
from tests.test_pipeline_stages import (_corrupted_tracks, _unit, make_feats,
                                        repetitive_texture_features)

torch.set_num_threads(2)


def _port_feats(jfeats):
    return Features.from_numpy(jax.tree.map(np.asarray, jfeats), "cpu")


def _ref_gumbel(n_pairs, H, K, chunk, seed=0):
    """The draws the reference's verify_matches makes: per chunk starting at
    s, PRNGKey(seed + s) split over the padded chunk, one (H,K) Gumbel per
    pair."""
    parts = []
    for s in range(0, n_pairs, chunk):
        keys = jax.random.split(jax.random.PRNGKey(seed + s), chunk)
        g = jax.vmap(lambda k: jax.random.gumbel(k, (H, K)))(keys)
        parts.append(np.asarray(g)[:min(chunk, n_pairs - s)])
    return torch.from_numpy(np.concatenate(parts))


# ---------------------------------------------------------------------------
# Stage cache
# ---------------------------------------------------------------------------


def _match_result(rng, Np=7, K=32):
    valid = rng.random((Np, K)) > 0.9
    return tm.MatchResult(idx=torch.as_tensor(rng.integers(0, K, (Np, K))),
                          valid=torch.as_tensor(valid),
                          score=torch.as_tensor(rng.random((Np, K)).astype(np.float32)))


def test_stage_cache_match_coo_roundtrip(tmp_path):
    """test_pipeline_stages' COO round trip on the port: the accepted set
    comes back exactly, the rest as the (NEG, 0) convention, onto the
    cache's device; the artifact on disk is the sparse encoding."""
    res = _match_result(np.random.default_rng(0))
    cache = tp.StageCache(tmp_path, "cpu")
    assert cache.get_or_run("match", "k1", lambda: res) is res
    out = cache.get_or_run("match", "k1", lambda: (_ for _ in ()).throw(
        AssertionError("must hit cache")))
    v = res.valid
    assert isinstance(out, tm.MatchResult) and out.idx.dtype == torch.int64
    assert torch.equal(out.valid, v)
    assert torch.equal(out.idx[v], res.idx[v]) and torch.equal(out.score[v], res.score[v])
    assert bool((out.score[~v] == -1e30).all()) and bool((out.idx[~v] == 0).all())
    with open(next(tmp_path.glob("stages/match-*.pkl")), "rb") as f:
        assert pickle.load(f).get("__match_coo__")


def test_stage_cache_tuples_and_named_tuples(tmp_path):
    """The verify stage's (MatchResult, counts) tuple and a Features record
    come back as their own types."""
    rng = np.random.default_rng(1)
    res = _match_result(rng)
    cnt = torch.arange(7, dtype=torch.int32)
    cache = tp.StageCache(tmp_path, "cpu")
    cache.get_or_run("verify", "k", lambda: (res, cnt))
    r2, c2 = cache.get_or_run("verify", "k", lambda: None)
    assert isinstance(r2, tm.MatchResult) and torch.equal(c2, cnt)
    assert torch.equal(r2.valid, res.valid)
    sc = make_scene(n_cams=2, n_points=40)
    feats = _port_feats(make_feats(sc.uv[:, :32], np.ones((2, 32, 16), np.float32),
                                   np.ones((2, 32), bool)))
    cache.get_or_run("extract", "k", lambda: feats)
    f2 = cache.get_or_run("extract", "k", lambda: None)
    assert type(f2) is Features and type(f2.kp) is type(feats.kp)
    assert all(torch.equal(x, y) for x, y in zip(f2.kp, feats.kp))


def test_stage_cache_reads_the_reference_artifact(tmp_path):
    """A match stage the reference cached decodes in the port (and the
    other way round): the COO blob is plain numpy."""
    rng = np.random.default_rng(2)
    res = _match_result(rng)
    jres = JMatchResult(jnp.asarray(res.idx.numpy().astype(np.int32)),
                        jnp.asarray(res.valid.numpy()), jnp.asarray(res.score.numpy()))
    jp.StageCache(tmp_path / "a").get_or_run("match", "k", lambda: jres)
    got = tp.StageCache(tmp_path / "a", "cpu").get_or_run("match", "k", lambda: None)
    tp.StageCache(tmp_path / "b", "cpu").get_or_run("match", "k", lambda: res)
    back = jp.StageCache(tmp_path / "b").get_or_run("match", "k", lambda: None)
    v = res.valid.numpy()
    for x in (got, back):
        np.testing.assert_array_equal(np.asarray(x.valid), v)
        np.testing.assert_array_equal(np.asarray(x.idx)[v], res.idx.numpy()[v])
        np.testing.assert_array_equal(np.asarray(x.score)[v], res.score.numpy()[v])


def test_stage_key_equals_reference():
    cfg, jcfg = load_config(None, ["match.window=3"]), jload_config(None, ["match.window=3"])
    imgs = np.random.default_rng(3).random((2, 4, 5)).astype(np.float32)
    for parts in ((imgs, cfg.features), ("seed", cfg.features, cfg.match), (imgs,)):
        jparts = tuple(getattr(jcfg, "features" if p is cfg.features else "match")
                       if dataclasses.is_dataclass(p) else p for p in parts)
        assert tp._stage_key("match", *parts) == jp._stage_key("match", *jparts)
    assert tp._stage_key("match", imgs) != tp._stage_key("verify", imgs)


# ---------------------------------------------------------------------------
# Pair selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,mode,window", [(7, "exhaustive", 8), (9, "window", 3),
                                           (1, "exhaustive", 8), (5, "window", 8)])
def test_build_pairs_equals_reference(n, mode, window):
    got = tp.build_pairs(n, mode, window)
    ref = jp.build_pairs(n, mode, window)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.shape[1] == 2
    with pytest.raises(ValueError):
        tp.build_pairs(n, "retrieval", window)


def _loop_feats(rng):
    """test_pipeline_stages' 12 frames through 6 places; frame 11 revisits
    frame 0's place."""
    place = [0, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, 0]
    C, K, D = len(place), 64, 32
    pools = _unit(rng, 6 * K, D).reshape(6, K, D)
    desc = np.stack([pools[p] + 0.02 * rng.normal(size=(K, D)).astype(np.float32)
                     for p in place])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((C, K), bool)
    mask[3, 40:] = False
    uv = rng.uniform(0, 300, size=(C, K, 2)).astype(np.float32)
    return make_feats(uv, desc, mask), C


@pytest.mark.parametrize("k,window", [(3, 1), (2, 2)])
def test_build_pairs_retrieval_equals_reference(rng, k, window):
    """With the reference's k-means++ first index injected (its
    ``jax.random.choice`` draw over the valid rows), the same pair set; the
    loop closure (0, 11) is proposed and the list is not exhaustive."""
    jfeats, C = _loop_feats(rng)
    ref = jp.build_pairs_retrieval(jfeats, C, k=k, window=window)
    fmask = jnp.reshape(jfeats.kp.mask, (-1,))
    first = int(jax.random.choice(jax.random.PRNGKey(0), fmask.shape[0],
                                  p=fmask.astype(jnp.float32) / fmask.sum()))
    got = tp.build_pairs_retrieval(_port_feats(jfeats), C, k=k, window=window, first=first)
    np.testing.assert_array_equal(got, ref)
    pset = {tuple(p) for p in got.tolist()}
    assert (0, 11) in pset and (0, 1) in pset and len(pset) < C * (C - 1) // 2
    # the port's own draw finds the loop closure too
    own = tp.build_pairs_retrieval(_port_feats(jfeats), C, k=k, window=window, seed=5)
    assert (0, 11) in {tuple(p) for p in own.tolist()}


# ---------------------------------------------------------------------------
# Match, verify, tracks
# ---------------------------------------------------------------------------


def _repetitive_case(rng, n_cams=8):
    sc = make_scene(n_cams=n_cams, n_points=300, noise_px=0.2, seed=4)
    jfeats, feat_pt = repetitive_texture_features(sc, rng)
    intr = sc.intrinsics[None].astype(np.float32)
    cam_k = np.zeros(n_cams, np.int32)
    return sc, jfeats, feat_pt, intr, cam_k


@pytest.mark.parametrize("binary", [False, True])
def test_match_images_equals_reference(rng, binary):
    """Float (through ``match_pairs_float_auto``, K5's wrapper) and binary
    (Hamming on the bit words) matching of every exhaustive pair."""
    sc, jfeats, _, _, _ = _repetitive_case(rng, 6)
    bits = rng.integers(0, 2 ** 32, size=(*jfeats.kp.mask.shape, 16), dtype=np.uint32)
    jfeats = jfeats._replace(desc_bits=jnp.asarray(bits))
    ov = ["features.max_keypoints=160", f"match.binary={binary}"]
    pairs = tp.build_pairs(6, "exhaustive", 8)
    ref = jp.match_images(jfeats, pairs, jload_config(None, ov))
    got = tp.match_images(_port_feats(jfeats), pairs, load_config(None, ov))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(ref.idx)[v])
    np.testing.assert_allclose(got.score.numpy()[v], np.asarray(ref.score)[v], atol=1e-6)
    assert binary or v.sum() > 200


def test_verify_matches_equals_reference_with_injected_draws(rng):
    """Chunks of 8 pairs (28 pairs: 4 chunks, the last short), each with the
    reference's own per-chunk draws; inliers outside the threshold band
    and counts within its slack."""
    sc, jfeats, _, intr, cam_k = _repetitive_case(rng)
    ov = ["features.max_keypoints=160"]
    cfg, jcfg = load_config(None, ov), jload_config(None, ov)
    pairs = tp.build_pairs(8, "exhaustive", 8)
    jres = jp.match_images(jfeats, pairs, jcfg)
    jv, jcnt = jp.verify_matches(jfeats, pairs, jres, intr, cam_k, jcfg, chunk=8)
    feats = _port_feats(jfeats)
    res = tm.MatchResult.from_numpy(jres, "cpu")
    g = _ref_gumbel(len(pairs), cfg.match.gv_hypotheses, 160, 8)
    tv, tcnt = tp.verify_matches(feats, pairs, res, intr, cam_k, cfg, chunk=8, gumbel=g)
    # the squared Sampson errors under each pair's kept model, for the band
    from sfmx_torch.core import cameras

    xn = cameras.pixel_to_normalized(torch.as_tensor(intr)[:, None, :], feats.kp.uv)
    thr = (cfg.match.gv_px_thresh / float(np.mean(intr[:, :2]))) ** 2
    err = torch.cat([tm.geometric_verify_errors(g[s:s + 8], xn, feats.kp.mask,
                                                pairs[s:s + 8], tm.MatchResult(
                                                    *(x[s:s + 8] for x in res)),
                                                threshold=thr)[0]
                     for s in range(0, len(pairs), 8)]).numpy()
    band = np.abs(err / thr - 1.0) < 0.01
    jvalid, tvalid = np.asarray(jv.valid), tv.valid.numpy()
    np.testing.assert_array_equal(tvalid[~band], jvalid[~band])
    assert np.all(np.abs(tcnt.numpy() - np.asarray(jcnt)) <= band.sum(axis=1))
    assert tvalid.sum() > 300
    # pairs below gv_min_inliers keep nothing
    assert not tvalid[tcnt.numpy() < cfg.match.gv_min_inliers].any()


def test_slice_match_verify_tracks_removes_repetitive_texture_corruption(rng):
    """test_pipeline_stages' repetitive-texture scene through the port's
    match_images -> verify_matches -> build_tracks, beside sfmx's stage
    functions with the same draws: corrupted tracks and kept pairs within
    2 of the reference's; without verification the corruption is real
    (>= 10 corrupted tracks), with it nearly gone, as the reference test
    requires."""
    sc, jfeats, feat_pt, intr, cam_k = _repetitive_case(rng)
    ov = ["features.max_keypoints=160"]
    cfg, jcfg = load_config(None, ov), jload_config(None, ov)
    feats = _port_feats(jfeats)
    pairs = tp.build_pairs(8, "exhaustive", 8)
    res = tp.match_images(feats, pairs, cfg)
    g = _ref_gumbel(len(pairs), cfg.match.gv_hypotheses, 160, 256)
    vres, cnt = tp.verify_matches(feats, pairs, res, intr, cam_k, cfg, gumbel=g)
    jres = jp.match_images(jfeats, pairs, jcfg)
    jv, jcnt = jp.verify_matches(jfeats, pairs, jres, intr, cam_k, jcfg)

    def tracks(r, impl=None):
        idx, valid = np.asarray(r.idx), np.asarray(r.valid)
        if impl is None:
            return jtracks.build_tracks(pairs, idx, valid, 8, 160)
        return ttracks.build_tracks(pairs, idx, valid, 8, 160, impl=impl)

    bad_off = _corrupted_tracks(tracks(res, "native"), feat_pt)
    bad_on = _corrupted_tracks(tracks(vres, "native"), feat_pt)
    ref_on = _corrupted_tracks(tracks(jv), feat_pt)
    assert bad_off >= 10 and bad_on <= max(2, bad_off // 10)
    assert abs(bad_on - ref_on) <= 2
    kept = int((cnt >= cfg.match.gv_min_inliers).sum())
    ref_kept = int((np.asarray(jcnt) >= jcfg.match.gv_min_inliers).sum())
    assert abs(kept - ref_kept) <= 2 and kept >= 10
    assert _corrupted_tracks(tracks(vres, "numpy"), feat_pt) == bad_on


def test_build_front_end_logs_and_caches(rng, tmp_path):
    """The front end over precomputed features: one LOGGER record per stage
    with its metrics; a second run takes match and verify from the cache
    (records marked cached) and returns the same tracks."""
    import io

    sc, jfeats, _, intr, cam_k = _repetitive_case(rng)
    cfg = load_config(None, ["features.max_keypoints=160"])
    feats = _port_feats(jfeats)
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        old = LOGGER._stream
        LOGGER._stream = buf
        try:
            out = tp.build_front_end(None, intr, cam_k, cfg, "cpu", tmp_path, feats=feats,
                                     stage_seed="repetitive",
                                     generator=torch.Generator().manual_seed(0))
        finally:
            LOGGER._stream = old
        runs.append((out, buf.getvalue()))
    (f1, p1, r1, c1, tt1), log1 = runs[0]
    (f2, p2, r2, c2, tt2), log2 = runs[1]
    for stage, key in (("pairs", "n_pairs"), ("match", "matches"),
                       ("geometric_verify", "pairs_kept"), ("tracks", "tracks")):
        assert f'"stage": "{stage}"' in log1 and f'"{key}"' in log1, stage
    assert log2.count('"cached": true') == 2
    np.testing.assert_array_equal(p1, p2)
    assert torch.equal(r1.valid, r2.valid) and torch.equal(c1, c2)
    assert tt1.n_tracks == tt2.n_tracks > 0


def _capture(fn):
    import io

    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        return fn(), buf.getvalue()
    finally:
        LOGGER._stream = old


@pytest.fixture(scope="module")
def built_map(tmp_path_factory):
    """``build_map`` twice over precomputed features with a stage cache."""
    rng = np.random.default_rng(0)
    sc, jfeats, _, intr, cam_k = _repetitive_case(rng)
    cfg = load_config(None, ["features.max_keypoints=160", "recon.ransac_hypotheses=128"])
    workdir = tmp_path_factory.mktemp("build")
    run = lambda: tp.build_map(None, intr, cam_k, cfg, "cpu", workdir, feats=_port_feats(jfeats),
                               stage_seed="repetitive",
                               generator=torch.Generator().manual_seed(0))
    return sc, jfeats, intr, cam_k, _capture(run), _capture(run)


def test_build_map_registers_and_logs(built_map):
    import json

    from sfmx_torch.solvers import umeyama as tum

    sc, jfeats, intr, cam_k, ((scene, feats, tt, stats), log1), ((scene2, _, tt2, stats2), log2) = \
        built_map
    C = len(cam_k)
    assert stats["n_registered"] == C and stats["final_med_px"] < 1.0
    rmse, _ = tum.ate_rmse(scene.centers, torch.from_numpy(sc.centers.astype(np.float32)),
                           scene.cam_alive)
    assert float(rmse) < 0.1
    rec = [json.loads(l) for l in log1.splitlines() if '"stage": "reconstruct"' in l]
    assert len(rec) == 1
    for key in ("ba_path", "ba_calls", "components", "phase_s", "ba_call_s", "n_registered",
                "n_points", "final_med_px", "ba_iters_per_s", "wall_s"):
        assert key in rec[0], key
    assert "ba_fallbacks" not in rec[0]
    assert rec[0]["ba_path"]["mode"] == "planes" and rec[0]["components"][0]["registered"] == C
    # the second run takes match and verify from the cache and rebuilds the
    # same map (the reconstruction is seeded from cfg.recon.seed)
    assert log2.count('"cached": true') == 2 and tt2.n_tracks == tt.n_tracks
    assert stats2["n_registered"] == C
    assert torch.equal(scene2.cam_R, scene.cam_R) and torch.equal(scene2.X, scene.X)


def test_build_map_matches_reference(built_map):
    from sfmx.recon.incremental import reconstruct as jreconstruct
    from sfmx_torch.solvers import umeyama as tum

    sc, jfeats, intr, cam_k, ((scene, feats, tt, stats), _), _ = built_map
    jcfg = jload_config(None, ["features.max_keypoints=160", "recon.ransac_hypotheses=128"])
    jtt = jtracks.TrackTable(tt.obs_cam, tt.obs_feat, tt.obs_track, tt.n_tracks)
    jscene, jstats = jreconstruct(np.asarray(jfeats.kp.uv), np.asarray(jfeats.kp.mask), jtt, intr,
                                  cam_k, jcfg.recon)
    assert jstats["n_registered"] == stats["n_registered"]
    rmse, _ = tum.ate_rmse(scene.centers, torch.from_numpy(np.asarray(jscene.centers)),
                           scene.cam_alive)
    assert float(rmse) < 0.05
    assert abs(jstats["final_med_px"] - stats["final_med_px"]) < 0.1


def test_helpers_take_no_default_device(tmp_path):
    """``StageCache``, ``new_scene`` and ``load_scene`` name no device of
    their own: a caller who leaves it out gets a TypeError, not the CPU."""
    from sfmx_torch.mapstore import scene as tscene_mod

    with pytest.raises(TypeError):
        tp.StageCache(tmp_path)
    with pytest.raises(TypeError):
        tscene_mod.new_scene(2, 3, 4, np.ones(7, np.float32))
    tscene_mod.save_scene(tmp_path / "map",
                          tscene_mod.new_scene(2, 3, 4, np.ones(7, np.float32), device="cpu"))
    with pytest.raises(TypeError):
        tscene_mod.load_scene(tmp_path / "map")
    assert tscene_mod.load_scene(tmp_path / "map", "cpu").capacities == (2, 3, 4)


def test_scene_store_round_trips_with_reference(built_map, tmp_path):
    from sfmx.mapstore import scene as jscene_mod
    from sfmx_torch.mapstore import scene as tscene_mod

    scene = built_map[4][0][0]
    tscene_mod.save_scene(tmp_path / "port_map", scene, extra={"note": "port"})
    js = jscene_mod.load_scene(tmp_path / "port_map")
    for f in dataclasses.fields(tscene_mod.Scene):
        a, b = getattr(scene, f.name).numpy(), np.asarray(getattr(js, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert jscene_mod.load_manifest(tmp_path / "port_map")["extra"] == {"note": "port"}
    assert [f.name for f in dataclasses.fields(tscene_mod.Scene)] == \
        [f.name for f in dataclasses.fields(jscene_mod.Scene)] == list(tscene_mod.SCENE_FIELDS)
    # and the reverse: a store sfmx wrote
    jscene_mod.save_scene(tmp_path / "ref_map", js, extra={"note": "ref"})
    back = tscene_mod.load_scene(tmp_path / "ref_map", "cpu")
    for f in dataclasses.fields(tscene_mod.Scene):
        assert torch.equal(getattr(back, f.name), getattr(scene, f.name)), f.name
    cols = tscene_mod.load_scene_np(tmp_path / "port_map")
    np.testing.assert_array_equal(cols["cam_R"], scene.cam_R.numpy())
    # saving over an existing store works, and an empty scene has the reference's shapes
    tscene_mod.save_scene(tmp_path / "port_map", back)
    new = tscene_mod.new_scene(4, 10, 20, np.asarray(js.intr), device="cpu")
    jnew = jscene_mod.new_scene(4, 10, 20, js.intr)
    for f in dataclasses.fields(tscene_mod.Scene):
        np.testing.assert_array_equal(getattr(new, f.name).numpy(), np.asarray(getattr(jnew, f.name)))
    assert new.capacities == (4, 10, 20) and new.counts() == (0, 0, 0)
    np.testing.assert_allclose(scene.centers.numpy(), np.asarray(js.centers), atol=1e-6)


def test_pipeline_config_recon_equals_reference():
    assert dataclasses.asdict(load_config(None, []).recon) == dataclasses.asdict(
        jload_config(None, []).recon)
    assert load_config(None, ["recon.dense_ba=off"]).recon.dense_ba == "off"


# ---------------------------------------------------------------------------
# F14: a build without a generator repeats
# ---------------------------------------------------------------------------

# the stats a build times on the host clock; every other entry must repeat
_TIMING_KEYS = {"phase_s", "ba_total_s", "ba_iters_per_s", "ba_call_s", "component_loop_s"}


def _room_build_inputs(frames=8, width=160, height=120):
    from examples import room

    from sfmx_torch.cli.config import FeatureConfig, MatchConfig, PipelineConfig

    tex = room.RoomTexture(seed=7)
    focal = 280.0 * width / 320
    imgs = np.stack([room.render_room(tex, R, eye, width, height, focal)
                     for (R, _t, eye) in room.walk_poses(frames)])
    intr = np.array([[focal, focal, width / 2, height / 2, 0, 0, 0]], np.float32)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=512),
                         match=MatchConfig(pair_mode="window", window=6),
                         resize_to=(width, height), focal_factor=0.875)
    return imgs, intr, np.zeros(frames, np.int32), cfg


def test_build_map_without_generator_repeats():
    """F14: ``build_map`` with no generator draws verification's noise from
    one seeded ``cfg.recon.seed``, so two builds in one process are
    bit-equal (every scene and feature array, the track table, the stats
    but their timings), as the reference's builds repeat (fixed keys).
    The case is the one F14 was found on: 8 rendered room frames at
    160x120, window pairs, the global generator moved between the calls."""
    imgs, intr, cam_k, cfg = _room_build_inputs()
    runs = []
    for _ in range(2):
        runs.append(tp.build_map(imgs, intr, cam_k, cfg, "cpu"))
        torch.rand(7)                       # the global generator moves on
    (s1, f1, t1, st1), (s2, f2, t2, st2) = runs
    for k, v in s1.to_numpy().items():
        np.testing.assert_array_equal(v, s2.to_numpy()[k], err_msg=k)
    n1, n2 = f1.to_numpy(), f2.to_numpy()
    for a, b in zip((*n1.kp, n1.desc, n1.desc_bits), (*n2.kp, n2.desc, n2.desc_bits)):
        np.testing.assert_array_equal(a, b)
    for k in ("obs_cam", "obs_feat", "obs_track"):
        np.testing.assert_array_equal(getattr(t1, k), getattr(t2, k))
    drop = lambda st: {k: v for k, v in st.items() if k not in _TIMING_KEYS}
    assert drop(st1) == drop(st2)
