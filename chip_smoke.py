#!/usr/bin/env python3
"""Drive the sfmx_torch query-localization path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases (each asserts; any failure exits non-zero):
  1. device   — needs torch.cuda; prints the card and its power limit
  2. build    — compiles the CUDA kernels K1-K3 from sfmx_torch/csrc
  3. kernels  — each kernel against its plain PyTorch version at the main
                path's shapes (B=16, 480x640 and 240x320, L=5, K=1024/512),
                max abs error beside the stated tolerance, CUDA-event times
  4. map      — renders 24 keyframes of the textured room (640x480,
                f=560), extracts them on the card, back-projects every
                valid keypoint onto the room box at the true pose, and
                builds a VLAD localization map
  5. queries  — 16 held-out frames between keyframe poses through
                ``localize_images`` with the default PipelineConfig (the
                main path; kernel launch counts are taken around it), the
                0.2 m median-error gate; then 4 of them on the card against
                the plain path on the CPU with the same RANSAC noise, and the
                gather-path tripwire of bench.py on the port
  6. rate     — steady-state query-path frames/s (extraction + localize)
  7. profile  — only with --profile: device time per batch of extraction,
                localization and the whole path under torch.profiler, the
                device's busy share of the wall time, the top device ops;
                the profiler's table goes to chiprun_out/profile_query.txt
  8. counters — K1/K2/K3 kernel launches of the main-path run, checked
                against the count the path implies
The last two lines are the kernel JSON and the device JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W_IMG, H_IMG, FOCAL = 640, 480, 560.0
N_KEYFRAMES, N_QUERIES = 24, 16
INTR = np.array([FOCAL, FOCAL, W_IMG / 2, H_IMG / 2, 0.0, 0.0, 0.0], np.float32)
MEDIAN_GATE_M = 0.2

# kernel name -> (source, TPU kernel it replaces, stated tolerance on max abs error)
KERNELS = {
    "diffuse_segment": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:89", 1e-4),
    "response_levels": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:141", 1e-6),
    "describe_upright": ("sfmx_torch/csrc/describe.cu",
                         "sfmx/kernels/pallas_describe.py:172", 1e-5),
}
# Tolerances: K1 — the kernel contracts multiply-adds into FMAs and the
# Perona-Malik steps amplify last-bit differences (levels lie in [0,1]);
# K2 — responses peak near 1e-2, so 1e-6 is 1e-4 relative; K3 — cell means
# of [0,1] samples, summed in another order than the plain version.


def log(msg: str) -> None:
    print(msg, flush=True)


def render(tex, poses) -> np.ndarray:
    from tests import smoke_scenes

    return smoke_scenes.render(tex, poses, W_IMG, H_IMG, FOCAL)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per run."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    from sfmx_torch.kernels import _build

    t0 = time.perf_counter()
    for lib in ("scale_space", "describe"):
        _build.load(lib)
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc per library: {json.dumps({k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()})})")


def phase_kernels(images, dev) -> dict:
    """Each kernel vs its plain version on the main path's inputs."""
    import torch

    from sfmx_torch.kernels import describe as dsc
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import scale_space as ss

    cfg = F.ScaleSpaceConfig()
    K0 = 1024
    out = {}
    img = torch.as_tensor(images, device=dev)
    for octave in (0, 1):
        if octave:
            img = F._downsample2(img)
        K = max(64, K0 >> octave)
        B, H, W = img.shape
        L0 = F.gaussian_blur(img, float(cfg.sigmas[0])).contiguous()
        k2 = F.contrast_k2(L0).reshape(-1).contiguous()
        segs = F.level_taus(cfg)
        # K1: every segment from the same input on both paths
        plain_levels = [L0]
        for taus in segs:
            plain_levels.append(ss.diffuse_segment_plain(plain_levels[-1], k2, taus))
        err1 = max(float((ss.diffuse_segment(plain_levels[i], k2, taus)
                          - plain_levels[i + 1]).abs().max()) for i, taus in enumerate(segs))
        levels = torch.stack(plain_levels, dim=1).contiguous()
        # K2
        resp = ss.response_levels(levels, cfg.sigma_levels)
        resp_p = ss.response_levels_plain(levels, cfg.sigma_levels)
        err2 = float((resp - resp_p).abs().max())
        # K3 on the keypoints the path detects
        kp = F.detect(levels, resp_p, cfg, max_keypoints=K, threshold=1e-7)
        args = (levels, kp.uv, kp.level, kp.sigma, kp.mask)
        err3 = float((dsc.describe_upright(*args) - dsc.describe_upright_reference(*args))
                     .abs().max())
        torch.cuda.synchronize()

        def k1():
            L = L0
            for taus in segs:
                L = ss.diffuse_segment(L, k2, taus)

        def k1_plain():
            L = L0
            for taus in segs:
                L = ss.diffuse_segment_plain(L, k2, taus)

        times = {
            "diffuse_segment": (cuda_ms(k1), cuda_ms(k1_plain)),
            "response_levels": (cuda_ms(lambda: ss.response_levels(levels, cfg.sigma_levels)),
                                cuda_ms(lambda: ss.response_levels_plain(levels, cfg.sigma_levels))),
            "describe_upright": (cuda_ms(lambda: dsc.describe_upright(*args)),
                                 cuda_ms(lambda: dsc.describe_upright_reference(*args))),
        }
        errs = {"diffuse_segment": err1, "response_levels": err2, "describe_upright": err3}
        shape = f"B={B} {H}x{W} L={cfg.n_levels} K={K}"
        for name, err in errs.items():
            tol = KERNELS[name][2]
            ms, pms = times[name]
            log(f"[kernels] {name:17s} {shape}: max_abs_err {err:.3e} (tol {tol:.0e}); "
                f"kernel {ms:.3f} ms, plain {pms:.3f} ms"
                + (" (all 4 segments)" if name == "diffuse_segment" else ""))
            assert err <= tol, f"{name} at {shape}: max_abs_err {err} > {tol}"
            if octave == 0:
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
            else:
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


def phase_map(tex, dev):
    from examples import room

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import build_localization_map
    from tests import smoke_scenes

    poses = room.walk_poses(N_KEYFRAMES)
    t0 = time.perf_counter()
    frames = render(tex, poses)
    t_render = time.perf_counter() - t0
    cfg = PipelineConfig()
    feats = extract_features(frames, cfg, dev)
    uv = feats.kp.uv.cpu().numpy()
    mask = feats.kp.mask.cpu().numpy()
    scene, obs_feat = smoke_scenes.room_scene(poses, uv, mask, INTR, room.ROOM)
    lmap = build_localization_map(scene, feats.desc.cpu().numpy(), obs_feat, dev,
                                  kp_mask=mask, n_words=64, seed=0)
    P = lmap.X.shape[0]
    assert lmap.vocab is not None, "map has no VLAD vocabulary"
    assert P < cfg.localize.streaming_min_landmarks, f"{P} landmarks would need streaming"
    log(f"[map] {N_KEYFRAMES} keyframes rendered in {t_render:.1f} s; "
        f"{int(mask.sum())} keypoints -> {P} landmarks, vocab {tuple(lmap.vocab.shape)}")
    return lmap


def query_poses():
    """Held-out frames at the midpoints between keyframe poses."""
    from examples import room

    mids = room.walk_poses(2 * N_KEYFRAMES - 1)[1::2]          # 23 midpoints
    pick = np.round(np.linspace(0, len(mids) - 1, N_QUERIES)).astype(int)
    return [mids[i] for i in pick]


def phase_queries(tex, lmap, dev):
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.kernels import _build

    poses = query_poses()
    frames = render(tex, poses)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    t0 = time.perf_counter()
    results = localize_images(frames, INTR, lmap, PipelineConfig(), generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES.counts)
    errs = []
    for i, (res, (_R, _t, eye)) in enumerate(zip(results, poses)):
        c = np.asarray(res["center"])
        assert np.isfinite(c).all() and np.isfinite(np.asarray(res["R"])).all(), \
            f"query {i}: non-finite pose"
        errs.append(float(np.linalg.norm(c - eye)))
        log(f"[queries] {i:2d}: center error {errs[-1]:.4f} m, "
            f"{res['n_inliers']} inliers, confidence {res['confidence']:.3f}")
    med = float(np.median(errs))
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[queries] median center error {med:.4f} m (gate < {MEDIAN_GATE_M}); "
        f"{n_conf}/{N_QUERIES} with confidence > 0; first main-path run {wall:.2f} s")
    assert len(results) == N_QUERIES
    assert med < MEDIAN_GATE_M, f"median center error {med} m"
    assert n_conf >= 12, f"only {n_conf} queries localized with confidence > 0"
    return frames, launches


def phase_crosscheck(frames, lmap, dev, n: int = 4):
    """The card's path against the plain path (CPU tensors, no kernels) on
    the first n queries, with the same RANSAC noise: centers within 3 cm and
    inlier counts within 3% (the tolerance tests/test_torch_slice.py states
    for last-bit differences in the levels)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.localize.localize import LocalizationMap
    from sfmx_torch.solvers.ransac import gumbel_noise

    cfg = PipelineConfig()
    shape = (n, cfg.localize.k_hypotheses, cfg.features.max_keypoints)
    g = gumbel_noise(shape, device="cpu", generator=torch.Generator().manual_seed(3))
    on_card = localize_images(frames[:n], INTR, lmap, cfg, gumbel=[g.to(dev)])
    cpu_map = LocalizationMap(*(None if x is None else x.cpu() for x in lmap))
    plain = localize_images(frames[:n], INTR, cpu_map, cfg, gumbel=[g])
    for i, (a, b) in enumerate(zip(on_card, plain)):
        dc = float(np.linalg.norm(np.asarray(a["center"]) - np.asarray(b["center"])))
        log(f"[crosscheck] query {i}: card vs plain center {dc:.2e} m, "
            f"inliers {a['n_inliers']} vs {b['n_inliers']}")
        assert dc < 0.03, f"query {i}: card and plain centers {dc} m apart"
        assert abs(a["n_inliers"] - b["n_inliers"]) <= max(2, 0.03 * b["n_inliers"])


def phase_tripwire(dev):
    """bench.py's gather-path accuracy tripwire, on the port."""
    import torch

    from sfmx_torch.localize.localize import LocalizationMap, localize_query
    from tests.smoke_scenes import tripwire_case

    cols, q_desc, q_uv, intr = tripwire_case()
    K = len(q_uv)
    t = lambda a: torch.as_tensor(a, device=dev)
    res = localize_query(LocalizationMap.from_numpy(cols, dev), t(q_desc), t(q_uv),
                         t(np.ones(K, bool)), t(intr),
                         generator=torch.Generator(device=dev).manual_seed(7),
                         top_k_kf=8, m_cap=2048, k_hypotheses=512)
    n_inl, conf = int(res.n_inliers), float(res.confidence)
    terr = float(torch.linalg.vector_norm(res.t))
    rerr = float(torch.linalg.matrix_norm(res.R - torch.eye(3, device=dev)))
    log(f"[tripwire] gather path: {n_inl} inliers (gate >= {K // 2}), confidence {conf:.3f}, "
        f"|t| {terr:.2e} (gate < 0.05), |R-I| {rerr:.2e} (gate < 0.02)")
    assert n_inl >= K // 2 and conf > 0.5 and terr < 0.05 and rerr < 0.02, "tripwire failed"


def query_path(frames, lmap, dev):
    """The query path on one device-resident batch, as two closures:
    extraction, then ``localize_batch`` on its features."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import localize_batch

    cfg = PipelineConfig()
    lc = cfg.localize
    imgs = torch.as_tensor(frames, device=dev)
    intr = torch.as_tensor(INTR, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = {}

    def extract():
        state["f"] = extract_features(imgs, cfg, dev)

    def localize():
        f = state["f"]
        localize_batch(lmap, f.desc, f.kp.uv, f.kp.mask, intr, generator=gen,
                       top_k_kf=lc.top_k_kf, m_cap=lc.m_cap, k_hypotheses=lc.k_hypotheses,
                       px_thresh=lc.px_thresh, sim_thresh=lc.sim_thresh,
                       min_inliers=lc.min_inliers)

    extract()
    return extract, localize


def phase_rate(extract, localize, n_frames: int, smi: str, reps: int = 5) -> float:
    """Steady-state query-path frames/s on the device: extraction + localize.
    Returns the median wall time of one batch in seconds."""
    import torch

    ms_extract = cuda_ms(extract, reps=reps)
    ms_localize = cuda_ms(localize, reps=reps)
    for _ in range(2):
        extract()
        localize()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        extract()
        localize()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    log(f"[rate] query path B={n_frames} {H_IMG}x{W_IMG}: {n_frames / wall:.2f} frames/s "
        f"(median {wall * 1e3:.2f} ms per batch of {reps}; extraction {ms_extract:.2f} ms, "
        f"localization {ms_localize:.2f} ms by CUDA events) on {smi}")
    return wall


def device_ms_per_run(fn, reps: int):
    """Run fn() reps times under torch.profiler.  Returns the device time per
    run in ms (the summed durations of every kernel, copy and fill the trace
    holds; the path runs on one stream, so they do not overlap), the device
    time per run of each kernel name, and the profiler's table."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    return sum(by_name.values()), by_name, table


def phase_profile(extract, localize, wall: float, smi: str, reps: int = 3):
    """Device time of each stage and of the whole path under torch.profiler,
    and the device's busy share of the unprofiled wall time per batch.  The
    full table goes to chiprun_out/profile_query.txt."""
    def path():
        extract()
        localize()

    ms_e, _, _ = device_ms_per_run(extract, reps)
    ms_l, _, _ = device_ms_per_run(localize, reps)
    ms_p, by_name, table = device_ms_per_run(path, reps)
    assert ms_p > 0, "the profiler recorded no device time"
    log(f"[profile] device time per batch (torch.profiler, {reps} batches each): "
        f"extraction {ms_e:.3f} ms, localization {ms_l:.3f} ms, whole path {ms_p:.3f} ms; "
        f"wall per batch without the profiler {wall * 1e3:.2f} ms; "
        f"device busy {ms_p / (wall * 1e3):.3f} of it, on {smi}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:8.3f} ms  {name[:100]}")
    out = ROOT / "chiprun_out" / "profile_query.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(f"{smi}\nwhole path, {reps} batches\n{table}\n")


def main() -> int:
    import torch

    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import sfmx_torch  # noqa: F401  (sets the TF32 flags)
    from examples import room
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import features as F

    dev = torch.device("cuda", 0)
    phase_build()
    tex = room.RoomTexture(seed=0)
    probe = render(tex, query_poses())
    kstats = phase_kernels(probe, dev)
    lmap = phase_map(tex, dev)
    frames, launches = phase_queries(tex, lmap, dev)
    phase_crosscheck(frames, lmap, dev)
    phase_tripwire(dev)
    extract, localize = query_path(frames, lmap, dev)
    wall = phase_rate(extract, localize, len(frames), smi)
    if "--profile" in sys.argv[1:]:
        phase_profile(extract, localize, wall, smi)

    # one chunk of 16 queries through 2 octaves; per octave, K1 launches one
    # kernel per FED step of its 4 level segments, K2 two (gradients, then
    # the determinant of all levels) and K3 one
    fcfg = PipelineConfig().features
    n_chunks, n_oct = 1, fcfg.n_octaves
    n_steps = sum(len(taus) for taus in F.level_taus(
        F.ScaleSpaceConfig(sigma_levels=tuple(fcfg.sigma_levels))))
    expected = {"diffuse_segment": n_steps * n_oct * n_chunks,
                "response_levels": 2 * n_oct * n_chunks,
                "describe_upright": n_oct * n_chunks}
    log(f"[counters] main-path launches {json.dumps(launches)}; expected {json.dumps(expected)}")
    for k, n in expected.items():
        assert launches.get(k, 0) == n > 0, f"{k}: {launches.get(k, 0)} launches, expected {n}"

    kernels = [{"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
                "launches": launches[k], **kstats[k]} for k in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
