"""Localization serving: a micro-batching device queue + HTTP API
(port of ``sfmx.serve.server``).

Clients send an image (or pre-extracted features), an optional beacon
prior and a map id, and get a 6-DoF pose back.  Concurrent requests are
micro-batched: a background loop drains the queue every
``batch_window_ms`` (up to ``max_batch`` requests), and the whole batch —
extraction on the card for image requests, then one localization call per
(map, feature count, binary) group — runs in a worker thread, so the event
loop keeps accepting requests meanwhile.  On a map of
``LocalizeConfig.streaming_min_landmarks`` or more landmarks the group goes
through ``localize_batch_streaming`` (kernel K4 against the whole pool).  A
map loaded with ``shards > 1`` is split across devices and each query is
routed by retrieval to its shard (``serve/router.py``).
Batches hold exactly the requests that arrived: PyTorch runs eagerly, so
there is no compiled-shape set to bound by padding.  Each stage of a batch
is a profiler span (``utils.logging.span``: ``serve.batch`` > ``serve.extract``
> ``extract``, and ``serve.localize`` > ``serve.stack``, ``localize.match``,
``localize.ransac``, ``localize.refine``, ``serve.readback``,
``serve.respond``); serving writes no stage record.
"""
from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import io
import time

import numpy as np
import torch

from ..localize.fusion import BeaconPrior, fuse
from ..localize.localize import (LocalizationMap, LocalizeResult, localize_batch,
                                 localize_batch_streaming, use_streaming)
from ..utils.logging import span
from .router import MapShardRouter, split_localization_map


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    image_requests: int = 0
    batches: int = 0
    total_latency_ms: float = 0.0
    total_batch_size: int = 0
    # ring buffer of recent latencies for percentile export
    recent_latencies: list = dataclasses.field(default_factory=list)
    _recent_cap: int = 1024

    def record_latency(self, ms: float):
        self.requests += 1
        self.total_latency_ms += ms
        if len(self.recent_latencies) >= self._recent_cap:
            self.recent_latencies.pop(0)
        self.recent_latencies.append(ms)

    def snapshot(self):
        lat = sorted(self.recent_latencies)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "requests": self.requests,
            "image_requests": self.image_requests,
            "batches": self.batches,
            "mean_latency_ms": self.total_latency_ms / max(self.requests, 1),
            "p50_latency_ms": pct(0.50),
            "p95_latency_ms": pct(0.95),
            "p99_latency_ms": pct(0.99),
            "mean_batch_size": self.total_batch_size / max(self.batches, 1),
        }


@dataclasses.dataclass
class _Request:
    map_id: str
    prior: BeaconPrior | None
    fut: asyncio.Future | None
    # feature payload (numpy from a client, or device tensors from extraction)
    q_desc: np.ndarray | torch.Tensor | None = None
    q_uv: np.ndarray | torch.Tensor | None = None
    q_mask: np.ndarray | torch.Tensor | None = None
    q_bits: np.ndarray | torch.Tensor | None = None
    # image payload ((H,W) float32 grayscale in [0,1])
    image: np.ndarray | None = None
    intr: np.ndarray | None = None   # per-request intrinsics override


class LocalizationService:
    """Micro-batching front of the extraction + localization path."""

    def __init__(self, *, batch_window_ms: float = 5.0, max_batch: int = 32,
                 seed: int = 0):
        self.maps: dict[str, tuple] = {}   # id -> (lmap, intr (7,), cfg)
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self.stats = ServiceStats()
        self._queue: asyncio.Queue | None = None
        self._task = None
        self._seed = seed
        # RANSAC noise: one generator per map device, seeded with ``seed``
        self._gens: dict[torch.device, torch.Generator] = {}

    def load_map(self, map_id: str, lmap: LocalizationMap, intr, cfg=None, *,
                 shards: int = 1):
        """Serve ``lmap`` (already on its device) under ``map_id``.  cfg is
        the PipelineConfig the map was built with; image requests are
        extracted with it (queries must use the map's extractor family).

        shards > 1 splits the map into that many keyframe-contiguous shards,
        each on its own device (the visible cards for a map on a card, else
        the map's device; round-robin when there are more shards than
        devices), and routes each query by retrieval
        to its shard (``router.MapShardRouter``: the building-scale path;
        float descriptors only, as in the reference).  Image requests are
        extracted on the first device and their features go to the shard's."""
        if cfg is None:
            from ..cli.config import PipelineConfig

            cfg = PipelineConfig()
        obj = lmap
        if shards > 1:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if lmap.X.device.type == "cuda" else [lmap.X.device])
            obj = MapShardRouter.build(split_localization_map(lmap, shards), devices)
        for dev in (obj.devices if shards > 1 else [lmap.X.device]):
            if dev not in self._gens:
                self._gens[dev] = torch.Generator(device=dev).manual_seed(self._seed)
        intr = torch.tensor(np.asarray(intr, np.float32), device=_device(obj))
        self.maps[map_id] = (obj, intr, cfg)

    def warmup(self, map_id: str):
        """Build the kernels and run one batch of blank images through
        extraction and localization, so the first request pays no build.
        A routed map localizes the batch on every shard: routing would send
        it to one, and a card's first call pays its own initialization
        (seconds, a mid-traffic stall on that card's first query)."""
        lmap, _intr, cfg = self.maps[map_id]
        W, H = cfg.resize_to
        reqs = [_Request(map_id, None, None, image=np.zeros((H, W), np.float32))
                for _ in range(self.max_batch)]
        self._extract(reqs)
        routed = isinstance(lmap, MapShardRouter)
        for shard in range(len(lmap.shards)) if routed else [None]:
            with on_device(_device(lmap)):
                self._localize_group(map_id, reqs, self._binary(reqs[0]), shard=shard)
        for dev in set(lmap.devices) if routed else [lmap.X.device]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    async def start(self):
        self._queue = asyncio.Queue()
        self._task = asyncio.create_task(self._batch_loop())

    async def stop(self):
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def localize(self, map_id: str, q_desc=None, q_uv=None, q_mask=None,
                       prior: BeaconPrior | None = None, *,
                       image: np.ndarray | None = None,
                       q_bits=None, intr=None) -> dict:
        """Enqueue one query: pre-extracted features (q_desc/q_uv/q_mask
        [, q_bits]) or a decoded grayscale image (extracted server-side in
        the batch)."""
        t0 = time.perf_counter()
        fut = asyncio.get_running_loop().create_future()
        req = _Request(map_id, prior, fut, q_desc=q_desc, q_uv=q_uv,
                       q_mask=q_mask, q_bits=q_bits, image=image, intr=intr)
        if image is not None:
            self.stats.image_requests += 1
        await self._queue.put(req)
        out = await fut
        dt = (time.perf_counter() - t0) * 1e3
        self.stats.record_latency(dt)
        out["latency_ms"] = dt
        return out

    async def _batch_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            req = await self._queue.get()
            batch = [req]
            deadline = time.perf_counter() + self.batch_window_ms / 1e3
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            self.stats.batches += 1
            self.stats.total_batch_size += len(batch)
            # device work in a worker thread: the event loop keeps accepting
            # (and batching) requests meanwhile
            results = await loop.run_in_executor(None, self._run_batch, batch)
            for r, res in results:
                if r.fut.done():
                    continue
                if isinstance(res, Exception):
                    r.fut.set_exception(res)
                else:
                    r.fut.set_result(res)

    # ---- synchronous device work (worker thread) ---------------------------

    def _binary(self, r: _Request) -> bool:
        # a routed map matches float descriptors only, as the reference's
        return (r.q_bits is not None
                and getattr(self.maps[r.map_id][0], "lm_bits", None) is not None)

    def _extract(self, reqs: list[_Request]):
        """Server-side extraction for image requests: one extraction
        (``_extract_raw``, under the span ``extract``) per (map, image
        shape) group; the features stay on the map's device and nothing is
        read back, so the batch goes on to localization while the device
        extracts."""
        from ..cli.pipeline import _extract_raw

        with span("serve.extract"):
            groups: dict[tuple, list[_Request]] = {}
            for r in reqs:
                groups.setdefault((r.map_id, r.image.shape), []).append(r)
            for (map_id, _shape), g in groups.items():
                lmap, _intr, cfg = self.maps[map_id]
                images = np.stack([r.image for r in g])
                with on_device(_device(lmap)), span("extract"):
                    feats = _extract_raw(images, cfg, _device(lmap))
                for i, r in enumerate(g):
                    r.q_desc, r.q_uv, r.q_mask = feats.desc[i], feats.kp.uv[i], feats.kp.mask[i]
                    r.q_bits = feats.desc_bits[i]

    def _run_batch(self, batch: list[_Request]):
        with span("serve.batch"):
            out: list[tuple[_Request, dict | Exception]] = []
            img_reqs = [r for r in batch if r.image is not None]
            if img_reqs:
                try:
                    self._extract(img_reqs)
                except Exception as e:  # reported to each request's caller
                    out.extend((r, e) for r in img_reqs)
                    batch = [r for r in batch if r.image is None]

            # group by (map id, K, binary): one batched call per group
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                if r.q_desc is None:
                    out.append((r, ValueError("no features or image in request")))
                    continue
                groups.setdefault((r.map_id, r.q_desc.shape[0], self._binary(r)), []).append(r)
            for (map_id, _k, binary), reqs in groups.items():
                try:
                    with on_device(_device(self.maps[map_id][0])):
                        out.extend(self._localize_group(map_id, reqs, binary))
                except Exception as e:  # reported to each request's caller
                    out.extend((r, e) for r in reqs)
            return out

    def _localize_group(self, map_id: str, reqs: list[_Request], binary: bool,
                        shard: int | None = None):
        with span("serve.localize"):
            lmap, intr0, cfg = self.maps[map_id]
            lc = cfg.localize
            dev = _device(lmap)

            def stack(name, dtype=None):
                return torch.stack([torch.as_tensor(getattr(r, name), dtype=dtype, device=dev)
                                    for r in reqs])

            with span("serve.stack"):
                q_desc, q_uv, q_mask = stack("q_desc"), stack("q_uv"), stack("q_mask", torch.bool)
                intr_b = torch.stack([intr0 if r.intr is None else
                                      torch.as_tensor(np.asarray(r.intr, np.float32), device=dev)
                                      for r in reqs])
                q_bits = torch.stack([torch.as_tensor(np.asarray(r.q_bits).view(np.int32))
                                      if isinstance(r.q_bits, np.ndarray) else r.q_bits
                                      for r in reqs]).to(dev) if binary else None
            kw = dict(top_k_kf=lc.top_k_kf, m_cap=lc.m_cap, k_hypotheses=lc.k_hypotheses,
                      px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
                      min_inliers=lc.min_inliers, ham_thresh=lc.ham_thresh,
                      pnp_solver=lc.pnp_solver)
            if isinstance(lmap, MapShardRouter):
                # multi-device map: each query to its shard's device, one
                # localize_batch call per shard group, every kwarg forwarded
                res, _ = lmap.localize_batch(q_desc, q_uv, q_mask, intr_b,
                                             generators=self._gens, shard=shard, **kw)
            elif binary:
                res = localize_batch(lmap, q_desc, q_uv, q_mask, intr_b,
                                     generator=self._gens[dev], q_bits=q_bits, **kw)
            elif use_streaming(lc, lmap, binary):
                # map-scale path: the whole batch against every landmark in ONE
                # K4 call; like the reference, the server passes no ratio
                res = localize_batch_streaming(
                    lmap, q_desc, q_uv, q_mask, intr_b, generator=self._gens[dev],
                    k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
                    sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers,
                    pnp_solver=lc.pnp_solver)
            else:
                res = localize_batch(lmap, q_desc, q_uv, q_mask, intr_b,
                                     generator=self._gens[dev], **kw)
            with span("serve.readback"):
                res = LocalizeResult(*(x.cpu() for x in res))
            with span("serve.respond"):
                out = []
                for i, r in enumerate(reqs):
                    one = LocalizeResult(*(x[i] for x in res))
                    fused = fuse(one, r.prior)
                    out.append((r, {
                        "t": one.t.tolist(),
                        "R": one.R.tolist(),
                        "center": fused.center.tolist(),
                        "n_inliers": int(one.n_inliers),
                        "confidence": float(fused.confidence),
                        "source": int(fused.source),
                    }))
            return out


def _device(lmap) -> torch.device:
    """Where a served map's queries are extracted and stacked: the map's
    device, or a router's first."""
    return lmap.devices[0] if isinstance(lmap, MapShardRouter) else lmap.X.device


def on_device(dev: torch.device):
    """The current card set to ``dev`` for the block (a no-op on the CPU).
    The batch runs in an executor thread, whose current card is cuda:0
    whatever card the map lives on, and the kernels launch on the current
    card's streams."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def decode_image_payload(data: bytes, resize_to=(640, 480)) -> np.ndarray:
    """Decode an uploaded JPEG/PNG to the (H,W) float32 grayscale in [0,1]
    the extractor consumes."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("L")
    if resize_to is not None:
        img = img.resize(resize_to, Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def make_app(service: LocalizationService):
    """aiohttp application exposing the serving surface.

    POST /localize  {map_id,
                     image: base64 JPEG/PNG           # preferred: pixels in
                     | features: {desc:[[...]], uv:[[x,y]...], bits?: [[...]]},
                     intrinsics?: [fx,fy,cx,cy,k1,k2,k3],
                     beacons?: {center:[x,y,z], radius, confidence}}
    GET  /maps      list loaded maps
    GET  /stats     serving metrics
    """
    from aiohttp import web

    async def localize(request: web.Request):
        body = await request.json()
        map_id = body["map_id"]
        if map_id not in service.maps:
            return web.json_response({"error": f"unknown map {map_id}"}, status=404)
        prior = None
        if body.get("beacons"):
            b = body["beacons"]
            prior = BeaconPrior(torch.tensor(b["center"], dtype=torch.float32),
                                float(b["radius"]), float(b.get("confidence", 0.5)))
        intr = (np.asarray(body["intrinsics"], np.float32)
                if body.get("intrinsics") else None)

        if body.get("image"):
            cfg = service.maps[map_id][2]
            try:
                img = decode_image_payload(base64.b64decode(body["image"]),
                                           resize_to=cfg.resize_to)
            except Exception as e:  # a bad upload is the client's error
                return web.json_response({"error": f"bad image: {e}"}, status=400)
            out = await service.localize(map_id, prior=prior, image=img, intr=intr)
            return web.json_response(out)

        if "features" not in body:
            return web.json_response(
                {"error": "request needs 'image' or 'features'"}, status=400)
        desc = np.asarray(body["features"]["desc"], np.float32)
        uv = np.asarray(body["features"]["uv"], np.float32)
        k_cap = 512
        K, D = desc.shape
        q_desc = np.zeros((k_cap, D), np.float32)
        q_uv = np.zeros((k_cap, 2), np.float32)
        q_mask = np.zeros(k_cap, bool)
        n = min(K, k_cap)
        q_desc[:n], q_uv[:n], q_mask[:n] = desc[:n], uv[:n], True
        q_bits = None
        if body["features"].get("bits"):
            bits = np.asarray(body["features"]["bits"], np.uint32)
            q_bits = np.zeros((k_cap, bits.shape[1]), np.uint32)
            q_bits[:n] = bits[:n]
        out = await service.localize(map_id, q_desc, q_uv, q_mask, prior,
                                     q_bits=q_bits, intr=intr)
        return web.json_response(out)

    async def maps(_request):
        return web.json_response({"maps": list(service.maps.keys())})

    async def stats(_request):
        return web.json_response(service.stats.snapshot())

    app = web.Application(client_max_size=32 * 1024 ** 2)
    app.router.add_post("/localize", localize)
    app.router.add_get("/maps", maps)
    app.router.add_get("/stats", stats)

    async def on_startup(_app):
        await service.start()

    async def on_cleanup(_app):
        await service.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app
