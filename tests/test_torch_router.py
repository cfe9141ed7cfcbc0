"""Retrieval-routed map shards of the port (``sfmx_torch.serve.router``)
against the reference's (``sfmx.serve.router``) on the same rendered room
map (``test_torch_serve.room_map``): the split and the routing bit-equal,
each shard group localized with one call on its shard's device, poses
within the localization tests' 1e-4 given the reference's RANSAC draws
(``fold_in(key, shard)`` split per group), and ``LocalizationService``
serving a map loaded with ``shards=4`` (``tests/test_router.py``,
``tests/test_serve.py::test_service_shard_routed_map``).  The router needs
no collective: on the CPU every shard lies on the one CPU device."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.serve import MapShardRouter as JRouter
from sfmx.serve import split_localization_map as jsplit
from sfmx_torch.serve import LocalizationService, MapShardRouter, split_localization_map

from .test_torch_serve import INTR, room_map  # noqa: F401  (fixture reuse)

KH = 256
KW = dict(k_hypotheses=KH, top_k_kf=4, m_cap=1024)


@pytest.fixture(scope="module")
def routers(room_map):  # noqa: F811
    jshards = jsplit(room_map["jmap"], 3)
    shards = split_localization_map(room_map["tmap"], 3)
    return (JRouter.build(jshards), MapShardRouter.build(shards, ["cpu"]), jshards, shards)


def _queries(room_map):
    """The 8 keyframes' own features and the 4 held-out frames'."""
    desc_kf, mask_kf, _bits, _obs = room_map["kf"]
    q_desc, q_uv, q_mask = room_map["q"]
    uv_kf = np.zeros((8, q_uv.shape[1], 2), np.float32)
    return (np.concatenate([desc_kf, q_desc]), np.concatenate([uv_kf, q_uv]),
            np.concatenate([mask_kf, q_mask]))


def test_split_covers_map(room_map, routers):  # noqa: F811
    """Three shards equal to the reference's field by field; every
    keyframe in exactly one, in order; the shards on their devices
    (round-robin over one CPU device); every pool a subset covering the map."""
    jr, tr, jshards, shards = routers
    assert len(tr.shards) == 3 and tr.devices == [torch.device("cpu")] * 3
    for j, t in zip(jshards, shards):
        for k in ("X", "lm_desc", "lm_alive", "kf_gdesc", "kf_alive", "kf_centers", "kf_lm",
                  "kf_lm_mask"):
            np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))
        assert t.vocab is room_map["tmap"].vocab
    lmap = room_map["tmap"]
    assert sum(s.kf_gdesc.shape[0] for s in tr.shards) == lmap.kf_gdesc.shape[0]
    assert all(s.X.shape[0] <= lmap.X.shape[0] for s in tr.shards)
    assert sum(s.X.shape[0] for s in tr.shards) >= lmap.X.shape[0]
    np.testing.assert_array_equal(tr.router_shard, jr.router_shard)
    np.testing.assert_array_equal(tr.router_gdesc.numpy(), np.asarray(jr.router_gdesc))


def test_routes_to_owning_shard_and_localizes(room_map, routers):  # noqa: F811
    """Routing equal to the reference's; a keyframe's own features retrieve
    its own keyframe's shard; the held-out queries localized on their
    shards with the reference's draws: n_inliers equal and poses within
    1e-4 of the reference router's, within 0.2 m of the truth."""
    jr, tr, _, _ = routers
    d, u, m = _queries(room_map)
    shard_of = tr.route(torch.from_numpy(d), torch.from_numpy(m))
    np.testing.assert_array_equal(shard_of, jr.route(jnp.asarray(d), jnp.asarray(m)))
    np.testing.assert_array_equal(shard_of[:8], tr.router_shard[:8])

    q = slice(8, 12)
    key = jax.random.PRNGKey(0)

    def ref_draws(sid, idx):
        nb = 1 << (len(idx) - 1).bit_length()
        keys = jax.random.split(jax.random.fold_in(key, sid), nb)[:len(idx)]
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k_, (KH, d.shape[1])))
                                          for k_ in keys]))

    ref, jshard = jr.localize_batch(jnp.asarray(d[q]), jnp.asarray(u[q]), jnp.asarray(m[q]),
                                    jnp.asarray(INTR), key, **KW)
    out, tshard = tr.localize_batch(*(torch.from_numpy(x[q]) for x in (d, u, m)),
                                    torch.from_numpy(INTR), gumbel=ref_draws, **KW)
    np.testing.assert_array_equal(tshard, jshard)
    np.testing.assert_array_equal(out.n_inliers.numpy(), np.asarray(ref.n_inliers))
    for name in ("R", "t", "center"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4)
    eyes = np.stack([p[2] for p in room_map["q_poses"]])
    assert (np.linalg.norm(out.center.numpy() - eyes, axis=1) < 0.2).all()


def test_batch_is_one_call_per_shard_group(room_map, routers, monkeypatch):  # noqa: F811
    """One ``localize_batch`` call per shard group (not per query), every
    group issued before any result is read; results in input order."""
    import sfmx_torch.serve.router as router_mod

    _, tr, _, _ = routers
    d, u, m = (torch.from_numpy(x) for x in _queries(room_map))
    calls = []
    real = router_mod.localize_batch

    def counting(lmap, q_desc, *a, **kw):
        calls.append(q_desc.shape[0])
        return real(lmap, q_desc, *a, **kw)

    monkeypatch.setattr(router_mod, "localize_batch", counting)
    gen = {torch.device("cpu"): torch.Generator().manual_seed(1)}
    res, shard_of = tr.localize_batch(d, u, m, torch.from_numpy(INTR), generators=gen, **KW)
    groups = np.unique(shard_of)
    assert len(calls) == len(groups) and sum(calls) == 12
    assert sorted(calls) == sorted(int((shard_of == s).sum()) for s in groups)
    assert res.center.shape == (12, 3)
    eyes = np.stack([p[2] for p in room_map["q_poses"]])
    assert (np.linalg.norm(res.center[8:].numpy() - eyes, axis=1) < 0.2).all()


def test_service_shard_routed_map(room_map):  # noqa: F811
    """``load_map(shards=4)``: the map split and routed, three concurrent
    feature requests localized (> 20 inliers, within 0.2 m)."""
    svc = LocalizationService(batch_window_ms=2.0, max_batch=8)
    svc.load_map("demo", room_map["tmap"], INTR, shards=4)
    assert isinstance(svc.maps["demo"][0], MapShardRouter)
    assert len(svc.maps["demo"][0].shards) == 4
    q_desc, q_uv, q_mask = room_map["q"]

    async def run():
        await svc.start()
        try:
            return await asyncio.gather(*[svc.localize("demo", q_desc[i], q_uv[i], q_mask[i])
                                          for i in (0, 1, 3)])
        finally:
            await svc.stop()

    outs = asyncio.run(run())
    eyes = [room_map["q_poses"][i][2] for i in (0, 1, 3)]
    for o, eye in zip(outs, eyes):
        assert o["n_inliers"] > 20
        assert np.linalg.norm(np.asarray(o["center"]) - eye) < 0.2


def test_warmup_reaches_every_shard(room_map, monkeypatch):  # noqa: F811
    """``warmup`` of a routed map localizes its blank batch on every shard:
    routing alone sends blank images (no features) to one shard, and on
    four cards the first query to each other card then paid its lazy
    initialization mid-traffic (``chip_smoke.py --cards 4`` phase 37:
    p99 2.9 s in the first run of traffic spread over the shards)."""
    import sfmx_torch.serve.router as router_mod

    svc = LocalizationService(batch_window_ms=2.0, max_batch=4)
    svc.load_map("demo", room_map["tmap"], INTR, shards=3)
    router = svc.maps["demo"][0]
    seen = []
    real = router_mod.localize_batch

    def recording(lmap, *a, **kw):
        seen.append(next(i for i, s in enumerate(router.shards) if s is lmap))
        return real(lmap, *a, **kw)

    monkeypatch.setattr(router_mod, "localize_batch", recording)
    blank = np.zeros((1, *room_map["q"][0].shape[1:]), np.float32)
    assert set(router.route(torch.from_numpy(blank), torch.zeros(1, blank.shape[1], dtype=bool))) \
        == {0}
    svc.warmup("demo")
    assert sorted(seen) == [0, 1, 2]
