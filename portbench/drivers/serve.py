"""Serving configurations: ``sfmx_torch.serve.server.LocalizationService`` in
the benchmark's process, driven by ``portbench.load``'s clients.

Set-up renders and extracts the building (``portbench.scenes.building``),
builds the program's map from it, starts the service at the configuration's
settings, warms it up and sends traffic until the window opens.  The window
counts every request answered in it.  Afterwards a sample of the window's
requests, drawn from the seed, is held against the plain reference
(``portbench.ref``): the program's own extraction, K4's matches and the
returned poses, as the timed path produced them.  The benchmark's spans
(``portbench.batch``, ``portbench.extract``, ``portbench.localize``) wrap
the service's calls into extraction and localization.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import seeding

MAP_ID = "building"
INFO: dict = {}      # what the last check saw besides its numbers (printed, not compared)
FAR_M = 1000.0      # a pose gap where one side localizes and the other does not


def pipeline_config(cfg: dict):
    """The program's PipelineConfig: its defaults, with the configuration's
    feature settings and ``pipeline`` overrides (dotted keys)."""
    from sfmx_torch.cli.config import PipelineConfig, _set_path

    pc = PipelineConfig()
    f = cfg["features"]
    pc = dataclasses.replace(pc, resize_to=(cfg["image"]["width"], cfg["image"]["height"]),
                             features=dataclasses.replace(
                                 pc.features, max_keypoints=f["max_keypoints"],
                                 threshold=f["threshold"], n_octaves=f["n_octaves"]))
    for k, v in cfg.get("pipeline", {}).items():
        pc = _set_path(pc, k, str(v))
    return pc


class Tap:
    """What the timed path produced for the watched requests (one in
    ``watch_every``, drawn from the seed): their features after the
    program's extraction and K4's rows for them, copied out of the batch's
    tensors on the device (a few small copies a batch, so no batch's
    tensors outlive it); and each batch's start, end and pool items, for
    the work counts and the batch times."""

    def __init__(self):
        self.watch: dict[int, int] = {}     # id(payload array) -> request seq
        self.got: dict[int, dict] = {}      # seq -> captured tensors
        self.batches: list[tuple] = []      # (t_start, [pid, ...])
        self.pid_of: dict[int, int] = {}    # id(payload array) -> pool item
        self.last_match = None


def make_service_class(tap: Tap, tracer):
    from torch.profiler import record_function

    from sfmx_torch.serve.server import LocalizationService

    class Service(LocalizationService):
        def _run_batch(self, batch):
            keys = [id(r.image if r.image is not None else r.q_desc) for r in batch]
            tracer.poll(lambda: (len(tap.batches), self.stats.batches - 1,
                                 self.stats.total_batch_size - len(batch)))
            t0 = time.perf_counter()
            with record_function("portbench.batch"):
                out = super()._run_batch(batch)
            tap.batches.append((t0, [tap.pid_of.get(k, -1) for k in keys], time.perf_counter()))
            for r, k in zip(batch, keys):
                seq = tap.watch.get(k)
                if seq is not None and r.image is not None:
                    tap.got.setdefault(seq, {}).update(uv=r.q_uv.clone(), mask=r.q_mask.clone(),
                                                       desc=r.q_desc.clone())
            return out

        def _extract(self, reqs):
            with record_function("portbench.extract"):
                return super()._extract(reqs)

        def _localize_group(self, map_id, reqs, binary, shard=None):
            with record_function("portbench.localize"):
                tap.last_match = None
                out = super()._localize_group(map_id, reqs, binary, shard=shard)
            m = tap.last_match
            if m is not None:
                K = m.idx.shape[0] // len(reqs)
                for i, r in enumerate(reqs):
                    k = id(r.image if r.image is not None else r.q_desc)
                    seq = tap.watch.get(k)
                    if seq is not None:
                        sl = slice(i * K, (i + 1) * K)
                        q = r.q_desc.clone() if hasattr(r.q_desc, "clone") else r.q_desc
                        tap.got.setdefault(seq, {}).update(
                            q_desc=q, idx=m.idx[sl].clone(), valid=m.valid[sl].clone(),
                            score=m.score[sl].clone())
            return out

    return Service


def tap_matcher(tap: Tap):
    """Keep a reference to the result of the streaming matcher's last call
    (K4's top-2 with the ratio test), as the timed path made it."""
    import sfmx_torch.localize.localize as loc

    orig = loc.match_float_streaming
    if getattr(orig, "_portbench_tap", None) is not None:
        orig = orig._portbench_tap

    def tapped(*a, **kw):
        m = orig(*a, **kw)
        tap.last_match = m
        return m

    tapped._portbench_tap = orig
    loc.match_float_streaming = tapped
    return orig


def untap_matcher(orig):
    import sfmx_torch.localize.localize as loc

    loc.match_float_streaming = orig


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str) -> dict:
    import torch

    from sfmx_torch.localize.localize import build_localization_map, use_streaming

    from .. import load as load_mod
    from .. import window
    from ..scenes.building import building
    from ..trace import Tracer

    b = building(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    pc = pipeline_config(cfg)
    t_map = time.perf_counter()
    lmap = build_localization_map(b["cols"], b["feat_desc"], b["obs_feat"], device,
                                  kp_mask=b["kp_mask"], n_words=cfg["map"]["n_words"], seed=0)
    n_lm = int(lmap.X.shape[0])
    assert n_lm >= cfg["map"]["landmarks"], f"map holds {n_lm} landmarks"
    assert use_streaming(pc.localize, lmap, False), "streaming='auto' does not pick K4"
    t_map = time.perf_counter() - t_map

    tap = Tap()
    tracer = Tracer(trace, float(cfg["trace_seconds"]))
    orig = tap_matcher(tap)
    svc = make_service_class(tap, tracer)(batch_window_ms=cfg["service"]["batch_window_ms"],
                                  max_batch=cfg["service"]["max_batch"],
                                  seed=seed & ((1 << 63) - 1))
    svc.load_map(MAP_ID, lmap, b["intr"], cfg=pc)
    t_warm = time.perf_counter()
    svc.warmup(MAP_ID)
    t_warm = time.perf_counter() - t_warm

    payload = traffic["payload"]
    pool = b["pool"]
    frames = b["pool_frames"]
    watch_rng = seeding.rng(seed, 5)
    every = int(cfg["check"]["watch_every"])

    async def submit(seq: int, pid: int):
        if payload == "image":
            arr = frames[pid]
            kw = {"image": arr}
        else:
            arr = pool["desc"][pid]
            kw = {"q_desc": arr, "q_uv": pool["uv"][pid], "q_mask": pool["mask"][pid]}
        key = id(arr)
        tap.pid_of[key] = pid
        if watch_rng.integers(every) == 0:
            tap.watch[key] = seq
        try:
            return await svc.localize(MAP_ID, **kw)
        finally:
            tap.watch.pop(key, None)
            tap.pid_of.pop(key, None)

    gen = load_mod.Load(traffic, seed, len(frames))
    marks = {}

    def on_open():
        marks["open_wall"] = time.time()
        tracer.request("start")

    async def session():
        # one thread runs the batches (they run one at a time), so the
        # profiler started there sees all of them; it starts (in its
        # warm-up phase: CUPTI's start takes seconds) before any traffic
        loop = asyncio.get_running_loop()
        loop.set_default_executor(ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="portbench-batch"))
        tracer.request("begin")
        await loop.run_in_executor(None, tracer.poll)
        await svc.start()
        try:
            return await gen.run(submit, seconds, on_open=on_open,
                                 on_close=lambda: tracer.request("stop"))
        finally:
            await svc.stop()

    gc.collect()
    gc.freeze()
    t_traffic = time.perf_counter()
    t_open, t_close = asyncio.run(session())
    if trace and tracer.pending:     # no batch came after the close: stop here
        tracer.poll()
    gc.unfreeze()
    untap_matcher(orig)
    setup_s = marks["open_wall"] - t_start
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    recs = gen.records
    done = window.completed_in(recs, t_open, t_close)
    sent = [r for r in recs if t_open <= r["t_sent"] < t_close]
    failed = [r for r in sent if not r["ok"]]
    lat_ms = [(r["t_done"] - r["t_sent"]) * 1e3 for r in done]
    traced = ([(r["t_done"] - r["t_sent"]) * 1e3 for r in done
               if tracer.t_open <= r["t_done"] < tracer.t_close] if tracer.t_close else [])

    # work the traced window's batches were sent: the batches it holds
    digest = tracer.digest(f"{scratch}/trace.json") if trace else None
    s0 = tracer.marks.get("start") or (len(tap.batches), 0, 0)
    s1 = tracer.marks.get("stop") or (len(tap.batches), 0, 0)
    in_win = [pids for _t, pids, _e in tap.batches[s0[0]:s1[0]]]
    bt = [1e3 * (e - t) for t, _p, e in tap.batches if t_open <= t < t_close]
    reqs_w = sum(len(p) for p in in_win)
    rows_w = sum(int(pool["mask"][p].sum()) for pids in in_win for p in pids if p >= 0)
    ctx = {
        "setup_s": setup_s,
        "window": {"seconds": t_close - t_open, "completed": len(done), "latency_ms": lat_ms,
                   "late_s": gen.late_s, "batch_ms": bt, "traced_latency_ms": traced},
        "service": {"batches": s1[1] - s0[1], "requests": s1[2] - s0[2]},
        "work": {"requests": reqs_w, "images": reqs_w if payload == "image" else 0,
                 "query_rows": rows_w, "landmarks": n_lm,
                 "height": cfg["image"]["height"], "width": cfg["image"]["width"],
                 "octaves": cfg["features"]["n_octaves"]},
        "trace": digest,
        "setup_parts": {**b["seconds"], "map": t_map, "warmup": t_warm,
                        "traffic_warmup": t_open - t_traffic},
    }

    # -- the check, once the window has closed and the program's state is freed
    watched = sorted(r["seq"] for r in done if r["seq"] in tap.got)
    by_seq = {r["seq"]: r for r in done}
    rng = seeding.rng(seed, 9)
    n_check = min(len(watched), int(cfg["check"]["sample"]))
    pick = sorted(rng.choice(len(watched), n_check, replace=False)) if n_check else []
    prog = []
    for i in pick:
        seq = watched[i]
        g = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
             for k, v in tap.got[seq].items()}
        pid = by_seq[seq]["pid"]
        sent_f = {} if payload == "image" else {k: pool[k][pid] for k in ("uv", "mask", "desc")}
        prog.append({"pid": pid, **sent_f, **g, **by_seq[seq]["result"]})
    del svc, lmap, tap, gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    numbers = check(cfg, b, prog, device, images=(payload == "image"), seed=seed)
    numbers["unanswered"] = (len(failed), 0)
    numbers["checked"] = (len(prog), int(cfg["check"]["min_checked"]))
    return {"ctx": ctx, "numbers": numbers, "attempted": len(sent), "failed": len(failed),
            "memory_peak_bytes": mem_peak, "check_s": time.perf_counter() - t_chk,
            "landmarks": n_lm}


# ---------------------------------------------------------------------------
# The comparison with the plain reference
# ---------------------------------------------------------------------------


def reference_records(cfg: dict, b: dict, pids, device, *, extract_dtype=None, cast=None,
                      geometry_bf16: bool = False, seed: int = 0, lm=None) -> list:
    """The plain reference for the pool items ``pids``, as the program's
    records give them: its extraction (the pool's, made in set-up, or made
    again in ``extract_dtype``), its matches (inputs rounded by ``cast``)
    and its pose (inputs and result rounded to bfloat16 with
    ``geometry_bf16``).  With the lower precisions it is the control, put
    in the program's place."""
    import torch

    from ..ref import extract as rx
    from ..ref import localize as rl

    lm = _landmarks(b, device) if lm is None else lm
    lc = cfg["localize"]
    out = []
    rng = seeding.rng(seed, 13)
    for pid in pids:
        if extract_dtype is None:
            f = {k: b["pool"][k][pid] for k in ("uv", "mask", "desc")}
        else:
            img = torch.from_numpy(b["pool_frames"][pid:pid + 1]).to(device)
            e = rx.extract(img, max_keypoints=cfg["features"]["max_keypoints"],
                           threshold=cfg["features"]["threshold"],
                           n_octaves=cfg["features"]["n_octaves"], dtype=extract_dtype)
            f = {"uv": e.uv[0].cpu().numpy(), "mask": e.mask[0].cpu().numpy(),
                 "desc": e.desc[0].cpu().numpy()}
        q = torch.from_numpy(f["desc"]).to(device)
        s1, i1, s2 = rl.top2(q, lm, cast=cast)
        ok = rl.accept(s1, s2, torch.from_numpy(f["mask"]).to(device), lc["ratio"], lc["sim_thresh"])
        idx, okn, s1n = i1.cpu().numpy(), ok.cpu().numpy(), s1.cpu().numpy()
        res = _ref_pose(cfg, b, f["uv"], idx, okn, rng, geometry_bf16)
        out.append({"pid": pid, **f, "q_desc": f["desc"], "idx": idx, "valid": okn,
                    "score": s1n, **res})
    return out


def _landmarks(b: dict, device):
    import torch

    from ..ref import localize as rl

    c = b["cols"]
    lm = rl.landmark_descriptors(b["feat_desc"], c["obs_cam"], b["obs_feat"], c["obs_pt"],
                                 len(c["X"]))
    return torch.from_numpy(lm).to(device)


def _bf16(a):
    import torch

    return torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16).to(torch.float64).numpy()


def _ref_pose(cfg, b, uv, idx, ok, rng, geometry_bf16: bool = False) -> dict:
    from ..ref import localize as rl

    lc, intr = cfg["localize"], b["intr"].astype(np.float64)
    thresh2 = (lc["px_thresh"] / (0.5 * (intr[0] + intr[1]))) ** 2
    xn = rl.normalized(uv, intr)
    X = b["cols"]["X"][idx].astype(np.float64)
    if geometry_bf16:
        xn, X = _bf16(xn), _bf16(X)
    got = rl.ransac_pnp(xn, X, ok, k_hypotheses=lc["k_hypotheses"], thresh2=thresh2, rng=rng)
    if got is not None and geometry_bf16:
        got = (_bf16(got[0]), _bf16(got[1]), got[2])
    if got is None:
        return {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0], "center": [0.0, 0.0, 0.0],
                "n_inliers": 0}
    R, t, n = got
    return {"R": R.tolist(), "t": t.tolist(), "center": rl.center(R, t).tolist(), "n_inliers": n}


def check(cfg: dict, b: dict, prog: list, device, *, images: bool, seed: int) -> dict:
    """The readings of the sampled requests, and of them the numbers the
    cell's configuration compares, each as (reading, limit); a reading
    above its limit makes the run not correct.

    - ``kp_miss``: share of keypoints, over the sampled requests, that the
      program and the plain extraction do not share within ``kp_px``
      pixels (image requests only);
    - ``desc_gap``: 99th percentile, over the reference's keypoints, of the
      largest descriptor entry difference to the program's nearest keypoint
      within ``desc_px`` pixels;
    - ``top2_gap``: 99.9th percentile, over the query rows the program
      accepted, of the amount by which the reference's best score over the
      whole pool lies above its score of the landmark the program matched
      (K4 against every landmark);
    - ``pose_cost_excess``: median, over the localized requests, of how far
      the summed squared reprojection error of a returned pose on the
      program's own correspondences that are inliers under it lies above
      the least that the reference's float64 refine reaches on them, as a
      share of that least;
    - ``pose_gap_m``: median distance between the returned camera center and
      the reference's, from the reference's own extraction, matches and
      RANSAC (``FAR_M`` where one of the two localizes and the other does
      not).
    """
    import torch

    from .. import window
    from ..ref import localize as rl

    lim = cfg["check"]["limits"]["image" if images else "features"]
    lc, intr = cfg["localize"], b["intr"].astype(np.float64)
    thresh2 = (lc["px_thresh"] / (0.5 * (intr[0] + intr[1]))) ** 2
    lm = _landmarks(b, device)
    X = b["cols"]["X"].astype(np.float64)
    ref = reference_records(cfg, b, [p["pid"] for p in prog], device, seed=seed, lm=lm)
    miss = tot = 0
    excess, dgaps, tgaps = [], [], []
    gaps = []
    for p, r in zip(prog, ref):
        if images:
            m, t, dg = _kp_compare(p, r, cfg["check"]["kp_px"], cfg["check"]["desc_px"])
            miss, tot = miss + m, tot + t
            dgaps.append(dg)
        corr = p["valid"] & (p["score"] > lc["sim_thresh"])
        rows = np.flatnonzero(corr)
        if len(rows):
            q = torch.from_numpy(np.ascontiguousarray(p["q_desc"][rows], np.float32)).to(device)
            best, _i, _s2 = rl.top2(q, lm)
            got = torch.sum(q * lm[torch.from_numpy(p["idx"][rows]).to(device)], dim=1)
            tgaps.append((best - got).cpu().numpy())
        loc_p = p["n_inliers"] >= lc["min_inliers"]
        loc_r = r["n_inliers"] >= lc["min_inliers"]
        if loc_p:
            xn = rl.normalized(p["uv"], intr)
            Xp = X[p["idx"]]
            R, t = np.asarray(p["R"], np.float64), np.asarray(p["t"], np.float64)
            inl = corr & (rl.residual2(R, t, xn, Xp) < thresh2)
            if inl.sum() >= 6:
                R2, t2 = rl.refine(R, t, xn[inl], Xp[inl])
                c0 = rl.residual2(R, t, xn[inl], Xp[inl]).sum()
                c1 = rl.residual2(R2, t2, xn[inl], Xp[inl]).sum()
                excess.append(float((c0 - c1) / max(c1, 1e-30)))
            else:
                excess.append(FAR_M)
        if loc_p and loc_r:
            gaps.append(float(np.linalg.norm(np.asarray(p["center"]) - np.asarray(r["center"]))))
        else:
            gaps.append(0.0 if loc_p == loc_r else FAR_M)
    out = {}
    INFO.update(localized_program=sum(p["n_inliers"] >= lc["min_inliers"] for p in prog),
                localized_reference=sum(r["n_inliers"] >= lc["min_inliers"] for r in ref),
                pose_gap_max_m=max(gaps) if gaps else None,
                inliers_program=[int(p["n_inliers"]) for p in prog][:8],
                inliers_reference=[int(r["n_inliers"]) for r in ref][:8])
    dg = np.concatenate(dgaps) if dgaps else np.zeros(0)
    tg = np.concatenate(tgaps) if tgaps else np.zeros(0)
    readings = {"kp_miss": miss / max(tot, 1),
                "desc_gap": window.percentile(dg.tolist(), 99) if len(dg) else 0.0,
                "desc_gap_max": float(dg.max()) if len(dg) else 0.0,
                "top2_gap": window.percentile(tg.tolist(), 99.9) if len(tg) else 0.0,
                "top2_gap_max": float(tg.max()) if len(tg) else 0.0,
                "pose_cost_excess": float(np.median(excess)) if excess else FAR_M,
                "pose_cost_excess_max": max(excess) if excess else FAR_M,
                "pose_gap_m": float(np.median(gaps)) if gaps else FAR_M}
    INFO["readings"] = readings
    return {k: (readings[k], v) for k, v in lim.items()}


def _kp_compare(p: dict, r: dict, px: float, desc_px: float):
    """(keypoints not shared within ``px``, all keypoints, each reference
    keypoint's largest descriptor entry difference to the program's nearest
    keypoint within ``desc_px``) between two keypoint sets."""
    up, ur = p["uv"][p["mask"]], r["uv"][r["mask"]]
    dp, dr = p["desc"][p["mask"]], r["desc"][r["mask"]]
    if len(up) == 0 or len(ur) == 0:
        return len(up) + len(ur), len(up) + len(ur), np.zeros(0)
    d2 = np.sum((ur[:, None, :].astype(np.float64) - up[None, :, :]) ** 2, axis=-1)
    j = np.argmin(d2, axis=1)
    hit = d2[np.arange(len(ur)), j] <= px * px
    i2 = np.argmin(d2, axis=0)
    hit_p = d2[i2, np.arange(len(up))] <= px * px
    near = d2[np.arange(len(ur)), j] <= desc_px * desc_px
    gap = np.abs(dr[near] - dp[j[near]]).max(axis=1)
    shared = int(hit.sum())
    return (len(ur) - shared) + (len(up) - int(hit_p.sum())), len(ur) + len(up), gap
