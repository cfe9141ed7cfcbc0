"""Serving parity: ``ServiceStats``, beacon ``fuse``, the micro-batching
``LocalizationService`` (image and feature requests, gather and streaming
paths) against ``sfmx.serve`` on a small rendered map, the aiohttp surface,
and the map loading of ``cli.main`` — the same inputs through both packages."""
import asyncio
import base64
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.cli.config import FeatureConfig as JFeatureConfig
from sfmx.cli.config import LocalizeConfig as JLocalizeConfig
from sfmx.cli.config import PipelineConfig as JPipelineConfig
from sfmx.cli.pipeline import _extract_raw as jextract
from sfmx.localize.fusion import BeaconPrior as JBeaconPrior
from sfmx.localize.fusion import fuse as jfuse
from sfmx.localize.localize import LocalizeResult as JResult
from sfmx.localize.localize import build_localization_map as jbuild
from sfmx.mapstore import lmap_store as jstore
from sfmx.mapstore.scene import Scene, save_scene
from sfmx.serve.server import LocalizationService as JService
from sfmx.serve.server import ServiceStats as JStats
from sfmx_torch.cli.config import FeatureConfig, LocalizeConfig, PipelineConfig
from sfmx_torch.cli.main import load_lmap, make_service
from sfmx_torch.localize.fusion import BeaconPrior, fuse
from sfmx_torch.localize.localize import LocalizationMap, LocalizeResult
from sfmx_torch.serve import LocalizationService, make_app
from sfmx_torch.serve.server import ServiceStats
from tests import smoke_scenes

torch.set_num_threads(2)

W, H, F = 192, 144, 168.0
INTR = np.array([F, F, W / 2, H / 2, 0, 0, 0], np.float32)


@pytest.mark.parametrize("lat", [[5.0] * 7, [3.0, 9.0, 1.0, 4.0, 4.0, 30.0], []])
def test_service_stats_snapshot_matches_reference(lat):
    """Identical latencies (every percentile the same value), a spread
    with a tie, and no traffic: the same snapshot dict."""
    a, b = ServiceStats(), JStats()
    for s in (a, b):
        for ms in lat:
            s.record_latency(ms)
        s.batches, s.total_batch_size, s.image_requests = 2, len(lat), 1
    assert a.snapshot() == b.snapshot()
    if lat and len(set(lat)) == 1:
        snap = a.snapshot()
        assert snap["p50_latency_ms"] == snap["p95_latency_ms"] == snap["p99_latency_ms"] == 5.0


@pytest.mark.parametrize("branch", ["no_prior", "blend", "zero_beacon_weight", "vision_failed"])
def test_fuse_matches_reference(branch):
    """All four branches of fuse (vision as-is; confidence-weighted blend;
    a prior of confidence 0, which leaves vision's center; vision below
    min_vision_conf, which takes the beacon's), batched over 3 queries:
    centers atol 1e-6, confidence and source equal."""
    rng = np.random.default_rng(1)
    conf = np.array([0.02, 0.01, 0.0] if branch == "vision_failed" else [0.9, 0.3, 0.06],
                    np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3)).copy()
    center = rng.normal(size=(3, 3)).astype(np.float32)
    vis = dict(R=R, t=np.zeros((3, 3), np.float32), n_inliers=np.full(3, 40, np.int32),
               confidence=conf, center=center)
    prior = None if branch == "no_prior" else (
        np.array([1.0, 2.0, 3.0], np.float32), 4.0, 0.0 if branch == "zero_beacon_weight" else 0.6)
    out = fuse(LocalizeResult(**{k: torch.from_numpy(v) for k, v in vis.items()}),
               None if prior is None else BeaconPrior(torch.from_numpy(prior[0]), *prior[1:]))
    for i in range(3):
        ref = jfuse(JResult(**{k: jnp.asarray(v[i]) for k, v in vis.items()}),
                    None if prior is None else JBeaconPrior(jnp.asarray(prior[0]), *prior[1:]))
        np.testing.assert_allclose(out.center[i].numpy(), np.asarray(ref.center), atol=1e-6)
        np.testing.assert_allclose(float(out.confidence[i]), float(ref.confidence), atol=1e-7)
        assert int(out.source[i]) == int(ref.source)
    expect = {"no_prior": 0, "blend": 2, "zero_beacon_weight": 0, "vision_failed": 1}[branch]
    assert (out.source.numpy() == expect).all()


def _pcfg(cls_p, cls_f, cls_l, streaming):
    return cls_p(features=cls_f(max_keypoints=256),
                 localize=cls_l(k_hypotheses=256, streaming=streaming), resize_to=(W, H))


@pytest.fixture(scope="module")
def room_map():
    """8 rendered keyframes -> a map built by sfmx (the same map handed to
    the port), 4 held-out query frames and sfmx's features of them."""
    from examples import room

    tex = room.RoomTexture(seed=0)
    kf_poses = room.walk_poses(8)
    q_poses = room.walk_poses(15)[2:12:3]
    frames = smoke_scenes.render(tex, kf_poses + q_poses, W, H, F)
    feats = jextract(frames, _pcfg(JPipelineConfig, JFeatureConfig, JLocalizeConfig, "off"))
    desc, uv, mask = (np.array(x) for x in (feats.desc, feats.kp.uv, feats.kp.mask))
    bits = np.array(feats.desc_bits)
    cols, obs_feat = smoke_scenes.room_scene(kf_poses, uv[:8], mask[:8], INTR, room.ROOM)
    O = len(obs_feat)
    scene = Scene(intr=jnp.asarray(INTR[None]), cam_k=jnp.zeros(8, jnp.int32),
                  obs_uv=jnp.zeros((O, 2), jnp.float32),
                  **{k: jnp.asarray(v) for k, v in cols.items()})
    jmap = jbuild(scene, desc[:8], obs_feat, kp_mask=mask[:8], n_words=16)
    tmap = LocalizationMap.from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()
                                       if v is not None}, "cpu")
    return dict(jmap=jmap, tmap=tmap, scene=scene, q_poses=q_poses, frames=frames[8:],
                q=(desc[8:], uv[8:], mask[8:]), kf=(desc[:8], mask[:8], bits[:8], obs_feat))


def _requests(room_map):
    """2 image requests (one with a beacon prior) and 2 feature requests
    (one with its own intrinsics), as keyword sets for both services."""
    desc, uv, mask = room_map["q"]
    fr = room_map["frames"]
    prior = (np.asarray(room_map["q_poses"][0][2], np.float32), 5.0, 0.4)
    return [dict(image=fr[0], prior=prior), dict(image=fr[1]),
            dict(q_desc=desc[2], q_uv=uv[2], q_mask=mask[2]),
            dict(q_desc=desc[3], q_uv=uv[3], q_mask=mask[3], intr=INTR.copy())]


def _run(svc, reqs, prior_cls, tensor):
    async def go():
        await svc.start()
        try:
            return await asyncio.gather(*[svc.localize(
                "room", **{k: v for k, v in r.items() if k != "prior"},
                prior=None if "prior" not in r else
                prior_cls(tensor(r["prior"][0]), *r["prior"][1:])) for r in reqs])
        finally:
            await svc.stop()
    return asyncio.run(go())


def _reference_noise(monkeypatch, B: int):
    """Make the port's service use the reference service's RANSAC noise for
    its first group of B requests: the reference splits its PRNGKey(0) once
    per group and gives query i the key split(k, B)[i] (B is a power of
    two, so no padding)."""
    import sfmx_torch.serve.server as server

    keys = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[1], B)

    def inject(fn):
        def call(lmap, q_desc, *a, **kw):
            kw.pop("generator")
            kw["gumbel"] = torch.from_numpy(np.stack([
                np.array(jax.random.gumbel(k_, (kw["k_hypotheses"], q_desc.shape[1])))
                for k_ in keys]))
            return fn(lmap, q_desc, *a, **kw)
        return call

    for name in ("localize_batch", "localize_batch_streaming"):
        monkeypatch.setattr(server, name, inject(getattr(server, name)))


@pytest.mark.parametrize("streaming", ["off", "on"])
def test_service_matches_reference_service(room_map, streaming, monkeypatch):
    """Concurrent image and feature requests through both services, on the
    gather path and on the streaming path, with the reference service's
    RANSAC noise: the same poses within 3 cm (image requests go through
    each package's own extraction, F1; on the streaming path a bf16 score
    at the ratio-test border can flip a match), gather-path feature
    requests within 1 mm;
    every request within 0.2 m of the truth, the prior fused (source 2),
    and the requests micro-batched (fewer batches than requests)."""
    reqs = _requests(room_map)
    _reference_noise(monkeypatch, len(reqs))
    jsvc = JService(batch_window_ms=200.0, max_batch=8)
    jsvc.load_map("room", room_map["jmap"], jnp.asarray(INTR),
                  cfg=_pcfg(JPipelineConfig, JFeatureConfig, JLocalizeConfig, streaming))
    ref = _run(jsvc, reqs, JBeaconPrior, jnp.asarray)
    svc = LocalizationService(batch_window_ms=200.0, max_batch=8)
    svc.load_map("room", room_map["tmap"], INTR,
                 cfg=_pcfg(PipelineConfig, FeatureConfig, LocalizeConfig, streaming))
    out = _run(svc, reqs, BeaconPrior, torch.as_tensor)
    eyes = [p[2] for p in room_map["q_poses"]]
    for i, (o, r, eye) in enumerate(zip(out, ref, eyes)):
        d = np.linalg.norm(np.asarray(o["center"]) - np.asarray(r["center"]))
        assert d < (1e-3 if i >= 2 and streaming == "off" else 0.03), (i, d)
        assert np.linalg.norm(np.asarray(o["center"]) - eye) < 0.2
        assert abs(o["n_inliers"] - r["n_inliers"]) <= max(2, 0.03 * r["n_inliers"])
        assert o["source"] == r["source"]
    assert [o["source"] for o in out] == [2, 0, 0, 0]
    st = svc.stats.snapshot()
    assert st["requests"] == 4 and st["image_requests"] == 2 and st["batches"] < 4


def test_service_binary_group_and_errors(room_map):
    """A binary map serves feature requests with bits on the Hamming gather
    path (grouped apart from float requests); a request with neither image
    nor features fails alone; shards > 1 raises (multi-GPU serving)."""
    desc, mask_kf, bits_kf, obs_feat = room_map["kf"]
    scene = {f.name: np.asarray(getattr(room_map["scene"], f.name))
             for f in dataclasses.fields(room_map["scene"])}
    from sfmx_torch.localize.localize import build_localization_map

    bmap = build_localization_map(scene, desc, obs_feat, "cpu", kp_mask=mask_kf, n_words=16,
                                  feat_bits=bits_kf)
    q_desc, q_uv, q_mask = room_map["q"]
    from sfmx.cli.pipeline import _extract_raw

    qb = np.array(_extract_raw(room_map["frames"][2:3],
                               _pcfg(JPipelineConfig, JFeatureConfig, JLocalizeConfig,
                                     "off")).desc_bits)[0]
    svc = LocalizationService(batch_window_ms=100.0, max_batch=8)
    svc.load_map("room", bmap, INTR, cfg=_pcfg(PipelineConfig, FeatureConfig, LocalizeConfig,
                                               "off"))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        svc.load_map("room2", bmap, INTR, shards=2)
    svc.warmup("room")
    assert svc.stats.requests == 0

    async def go():
        await svc.start()
        try:
            return await asyncio.gather(
                svc.localize("room", q_desc[2], q_uv[2], q_mask[2], q_bits=qb),
                svc.localize("room", q_desc[2], q_uv[2], q_mask[2]),
                svc.localize("room"), return_exceptions=True)
        finally:
            await svc.stop()

    b, f, bad = asyncio.run(go())
    eye = room_map["q_poses"][2][2]
    for o in (b, f):
        assert o["n_inliers"] >= 12 and np.linalg.norm(np.asarray(o["center"]) - eye) < 0.2
    assert isinstance(bad, ValueError)


def test_http_endpoints(room_map):
    """The aiohttp surface: /maps, /localize with features (+ beacons) and
    with a PNG upload, 404 for an unknown map, 400 for a bad image or a
    missing payload, /stats."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer
    from PIL import Image

    svc = LocalizationService(batch_window_ms=20.0, max_batch=8)
    svc.load_map("room", room_map["tmap"], INTR,
                 cfg=_pcfg(PipelineConfig, FeatureConfig, LocalizeConfig, "off"))
    desc, uv, mask = room_map["q"]
    d, u = desc[1][mask[1]], uv[1][mask[1]]
    buf = io.BytesIO()
    Image.fromarray((room_map["frames"][1] * 255).astype(np.uint8)).save(buf, format="PNG")
    png = base64.b64encode(buf.getvalue()).decode()
    eye = room_map["q_poses"][1][2]

    async def go():
        async with TestClient(TestServer(make_app(svc))) as client:
            assert (await (await client.get("/maps")).json()) == {"maps": ["room"]}
            feats = {"desc": d.tolist(), "uv": u.tolist()}
            r = await client.post("/localize", json={"map_id": "room", "features": feats})
            body = await r.json()
            assert r.status == 200 and body["n_inliers"] >= 12 and len(body["t"]) == 3
            assert np.linalg.norm(np.asarray(body["center"]) - eye) < 0.2
            r = await client.post("/localize", json={
                "map_id": "room", "features": feats,
                "beacons": {"center": eye.tolist(), "radius": 5.0, "confidence": 0.4}})
            assert (await r.json())["source"] == 2
            r = await client.post("/localize", json={"map_id": "room", "image": png})
            body = await r.json()
            assert r.status == 200 and np.linalg.norm(np.asarray(body["center"]) - eye) < 0.2
            r = await client.post("/localize", json={"map_id": "nope", "features": feats})
            assert r.status == 404
            r = await client.post("/localize", json={
                "map_id": "room", "image": base64.b64encode(b"junk").decode()})
            assert r.status == 400
            assert (await client.post("/localize", json={"map_id": "room"})).status == 400
            stats = await (await client.get("/stats")).json()
            assert stats["requests"] == 3 and stats["image_requests"] == 1

    asyncio.run(go())


def test_load_lmap_and_make_service(room_map, tmp_path):
    """A scene store and its .lmap written by sfmx load into the port (the
    same columns), a store without .lmap is aggregated from its
    .feats.npz (with bits when binary), and make_service serves both."""
    scene, jmap = room_map["scene"], room_map["jmap"]
    desc, mask_kf, bits_kf, obs_feat = room_map["kf"]
    save_scene(tmp_path / "a", scene)
    jstore.save_localization_map(tmp_path / "a.lmap", jmap)
    cols, lmap = load_lmap(tmp_path / "a", "cpu")
    np.testing.assert_array_equal(cols["X"], np.asarray(scene.X))
    for k, v in lmap.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jmap, k)), err_msg=k)
    save_scene(tmp_path / "b", scene)
    np.savez(tmp_path / "b.feats.npz", desc=desc, obs_feat=obs_feat, kp_mask=mask_kf,
             desc_bits=bits_kf)
    _, bmap = load_lmap(tmp_path / "b", "cpu", binary=True)
    assert bmap.lm_bits is not None and bmap.X.shape == lmap.X.shape
    cfg = _pcfg(PipelineConfig, FeatureConfig, LocalizeConfig, "off")
    svc = make_service([f"a={tmp_path / 'a'}", str(tmp_path / "b")], cfg, "cpu", warmup=False)
    assert set(svc.maps) == {"a", str(tmp_path / "b")}
    np.testing.assert_array_equal(svc.maps["a"][1].numpy(), INTR)
