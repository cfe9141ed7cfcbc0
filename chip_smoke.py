#!/usr/bin/env python3
"""Drive the sfmx_torch query-localization, map-scale serving, map-build
front-end and reconstruction paths once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--profile]
(``python3 chip_smoke.py --tune`` runs instead the sweeps behind K1's tile
and fused-step constants, K2's tile, K3's keypoints per block, K4's landmark
tile, ring depth and splits, K6's slot groups and K8's slot groups and
camera-table staging, and prints no result lines.)

Phases (each asserts; any failure exits non-zero):
  1. device     — needs torch.cuda; prints the card and its power limit
  2. build      — compiles the CUDA kernels K1-K10 from sfmx_torch/csrc,
                  one nvcc per source, and native/tracks.cpp with g++, all
                  started together
  3. kernels    — K1-K3 against their plain PyTorch versions at the gather
                  path's shapes (B=16, 480x640 and 240x320, L=5, K=1024/512),
                  max abs error beside the stated tolerance, CUDA-event times;
                  again at the serving run's batches (B=32 and the B=2 tail)
                  after phase 8, and the B=32 numbers go in the kernels line
                  (with --profile K3's device time per call by torch.profiler)
  4. map        — renders 24 keyframes of the textured room (640x480,
                  f=560), extracts them on the card, back-projects every
                  valid keypoint onto the room box at the true pose, and
                  builds a VLAD localization map (with majority-vote bits)
  5. queries    — 16 held-out frames through ``localize_images`` with the
                  default PipelineConfig (gather path; kernel launch counts
                  are taken around it), the 0.2 m median-error gate; then 4
                  of them on the card against the plain path on the CPU with
                  the same RANSAC noise, and the gather-path tripwire of
                  bench.py on the port
  6. rate       — steady-state gather-path frames/s (extraction + localize)
  7. tracking, p3p, binary — the 16 frames through ``localize_sequence``
                  (most must be tracked), with ``pnp_solver="p3p"`` and with
                  Hamming matching on the map's bits, each under the gate
  8. map-scale  — the 24 keyframes merged to one landmark per surface cell,
                  plus distractor rooms (other textures, translated away) up
                  to >= 131,072 landmarks, so ``streaming="auto"`` picks K4
  9. K4         — match_top2 against its plain version on the first serving
                  batch's query descriptors (32x1024 rows) and on the burst
                  tail's (2x1024 rows, where the kernel splits the landmark
                  loop and a second launch merges) vs the whole pool, each
                  with its own bound; split and unsplit results bit-equal;
                  with --profile what ``match_float_streaming`` adds around
                  the kernel (device ms, host us)
 10. serve      — 8 bursts, one after another, of 66 concurrent image
                  requests through ``LocalizationService`` (max_batch 32,
                  window 5 ms) under asyncio.gather, a quarter with a beacon
                  prior, two with their own intrinsics; gates over all 528:
                  streaming chosen, median center error < 0.2 m, >= 75 %
                  localized, batches < requests, each batch one streaming
                  localize call, K4 launches == the sum over those calls of
                  what the wrapper says their query rows take (2 where it
                  splits); p50/p95/p99 latency over all requests, mean
                  batch, requests/s
 11. streaming  — one B=32 batch through ``localize_batch_streaming`` on the
                  card and on the CPU's plain path with the same RANSAC
                  noise (centers within 3 cm), and steady-state frames/s of
                  extraction + streaming localize at B=32
 12. profile    — only with --profile: device time per batch of each stage
                  of both paths under torch.profiler, the device's busy
                  share of the wall time, the top device ops; the tables go
                  to chiprun_out/profile_*.txt
 13. front end  — renders a 256-frame VGA walk across the room and back and
                  runs ``build_front_end`` (extract, pairs, match, verify,
                  tracks; ``PipelineConfig()`` defaults: 1024 keypoints,
                  ratio 0.85, cross-check, 256 E-RANSAC hypotheses, 16
                  inliers per kept pair) three times, launch counts set to 0
                  before each: its first 96 frames exhaustively (4,560 pairs
                  on K5), all 256 by retrieval pairs (window 8, k 8) in band
                  tiles (K9, leftovers K5), and the 96 frames' window pairs
                  with binary descriptors (plain Hamming).  Stage walls,
                  pairs/s, tracks.  Gates: the plain matcher never runs on
                  the card; >= 95 % of verified matches join keypoints whose
                  raycast surface points lie within max(3 cm, the keypoint's
                  scale at its depth); >= 85 % of track observations that
                  close to their track's median point, and the track table
                  equal to the numpy union-find's; every adjacent-frame pair
                  keeps >= 16 inliers; a loop closure across the two passes
                  survives verification
 14. pair kernels — K5 and K9 against the plain matcher on the card at the
                  4,560 exhaustive pairs and at the band list (score within
                  1e-5, valid and accepted idx equal outside near-ties), K9
                  equal to K5 in every field; K10 (K5's raw mode) on 512
                  pairs as its own path, against its plain version; times
 15. front crosscheck — 16 adjacent pairs: the card's match and verify
                  stages against the plain CPU path with the same Gumbel
                  noise (valid equal outside near-ties; per pair, inlier
                  counts within 1 %, inlier masks equal but for matches near
                  the threshold and that slack); with --profile, device ms
                  and busy share per stage
 16. counters   — launches of the gather path's run against the count it
                  implies, of the serving run (K1-K4 all > 0), and of each
                  front-end build (K1-K3 per extraction call, K1 one per
                  chunk of fused FED steps, K2 one; K5 and K9 two per
                  wrapper call)
 17. BA kernels — a random bundle-adjustment problem of 512 cameras, 20,000
                  points and 200,000 observations (tp = 32 slots per point,
                  30 CG steps): K7, K6 and K8 against their plain versions
                  (errors relative to the largest entry beside the stated
                  tolerances), CUDA-event times, with --profile K6's and
                  K8's device time per call by torch.profiler (phase 18
                  repeats this at the build's own shapes, whose numbers go
                  into the kernels line), LM iterations/s of
                  ``ba_solve(dense_cg=True)`` beside the planes path, and
                  the same dense solve twice (bit-identical or not); with
                  --profile the solve's device ms and busy share
 18. build_map  — the 96-frame exhaustive build again, now through
                  ``build_map`` to a ``Scene`` (default ``PipelineConfig``,
                  ``max_components=1``), launch counts set to 0 before it.
                  Gates: 96/96 registered, median reprojection < 1 px, ATE
                  of the camera centers against the rendered poses < 0.1 m
                  after a similarity alignment, the final BA on the dense
                  path, K6/K7/K8 launched with K6 = (cg_iters + 2) x K7 and
                  K8 = K7 / 2 + dense BA calls (K7 is two launches a call,
                  K8 one, once per LM iteration and once per solve); then
                  K6-K8 against their plain versions on the final BA's
                  table
 19. loop       — ``save_scene``, ``load_scene_np``,
                  ``build_localization_map`` from the built scene, and 16
                  held-out frames localized against it: median center error
                  < 0.2 m after the same similarity, >= 12/16 localized
 20. BA crosscheck — one 8-camera ``ba_solve`` on the card (K6-K8) against
                  the plain path on the CPU
The last two lines are the kernel JSON and the device JSON.  K4's entry
holds the serving batch's shape and, as ``tail_ms``, ``tail_bound_ms`` and
``splits``, the burst tail's; ``ms`` times the wrapper on f32 descriptors
(its casts to bf16 included, as the main path calls it), ``launch_ms`` the
launches alone on bf16 inputs.  Every kernel
carries ``bound_ms``: the larger of its necessary bytes (inputs read once,
outputs written once) at 3.35 TB/s and its operations at the card's peak
for their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32), from this
run's shapes; ``library_ms`` is null throughout: no single PyTorch call
computes any of these functions (the matchers' plain versions are a matmul
plus top-k, mask and gather calls; the BA kernels' several gathers, block
products and ``index_add_`` calls).
"""
from __future__ import annotations

import contextlib
import dataclasses
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
MAP_SCALE_LANDMARKS = 131072   # >= 2x LocalizeConfig.streaming_min_landmarks
N_SERVE, SERVE_BATCH, SERVE_WINDOW_MS = 64, 32, 5.0
N_BURSTS = 8                   # serving bursts, one after another, on one service
N_TAIL = 2                     # images in a burst's last batch (66 = 32 + 32 + 2)
FOCAL_OWN = 600.0              # the two requests that carry their own intrinsics
RENDER_WORKERS = 8
N_BUILD, N_BAND = 96, 256      # exhaustive build (4,560 pairs); the band build's loop walk
N_K10_PAIRS, N_XCHECK_PAIRS = 512, 16
XCHECK_SLACK = 0.01            # card vs CPU verify: 1% of a pair's inliers (at least 2)
TRUTH_M, TRUTH_SHARE = 0.03, 0.95   # true match: surface points within 3 cm (or sigma)
TRACK_OBS_SHARE = 0.85         # true track observations (the reference's builder: 0.88-0.95)
NEAR_TIE = 1e-5                # score gap under which summation order may flip a winner

BA_SHAPE = dict(C=512, P=20000, O=200000, tp=32, cg_iters=30, lm_iters=10)
N_LOOP_QUERIES, N_LOOP_MIN = 16, 12
ATE_GATE_M, REPROJ_GATE_PX = 0.1, 1.0
HBM_BYTES_S, PEAK_OPS_S = 3.35e12, {"bf16": 989e12, "f32": 67e12}

SERVE_KERNELS = ("diffuse_segment", "response_levels", "describe_upright", "match_top2")
# kernel name -> (source, TPU kernel it replaces, stated tolerance on max abs error)
KERNELS = {
    "diffuse_segment": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:89", 1e-4),
    "response_levels": ("sfmx_torch/csrc/scale_space.cu",
                        "sfmx/kernels/pallas_scale_space.py:141", 1e-6),
    "describe_upright": ("sfmx_torch/csrc/describe.cu",
                         "sfmx/kernels/pallas_describe.py:172", 1e-5),
    "match_top2": ("sfmx_torch/csrc/match_top2.cu",
                   "sfmx/kernels/pallas_match.py:100", 1e-5),
    "match_pairs_fused": ("sfmx_torch/csrc/match_pairs.cu",
                          "sfmx/kernels/pallas_pairs.py:253", NEAR_TIE),
    "match_pairs_tiled": ("sfmx_torch/csrc/match_pairs.cu",
                          "sfmx/kernels/pallas_tiles.py:214", NEAR_TIE),
    "match_pairs_top2": ("sfmx_torch/csrc/match_pairs.cu",
                         "sfmx/kernels/pallas_pairs.py:127", NEAR_TIE),
    "schur_cross_matvec": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:302", 1e-4),
    "ba_assemble_fused": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:516", 1e-4),
    "ba_cost_fused": ("sfmx_torch/csrc/ba.cu", "sfmx/kernels/segsum.py:587", 1e-4),
}
# Tolerances: K1 — the kernel contracts multiply-adds into FMAs and the
# Perona-Malik steps amplify last-bit differences (levels lie in [0,1]);
# K2 — responses peak near 1e-2, so 1e-6 is 1e-4 relative; K3 — cell means
# of [0,1] samples, summed in another order than the plain version; K4, K5,
# K9, K10 — scores of unit vectors in [-1,1]: the bf16 products are exact in
# f32 and only the order of the 128-term sums differs, so winners are
# compared outside near-ties (a gap below NEAR_TIE); K6-K8 — errors relative
# to the output's largest entry: the reprojection residual is a difference
# of pixel coordinates ~300 that leaves ~0.3, so an FMA contracted otherwise
# moves it by ~3e-5 relative, a Huber weight delta/|r| repeats that, and the
# sums over a point's or a camera's observations run in another order.


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: necessary bytes at the memory
    rate against necessary operations at the peak rate of their type."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None}


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


def cuda_ms_per_call(fn, n: int = 20, reps: int = 5) -> float:
    """Median over reps of the CUDA-event time of n calls back to back, per
    call: past the first call the host's path overlaps the device's work,
    so a short kernel's time is not its wrapper's."""
    return cuda_ms(lambda: [fn() for _ in range(n)], reps=reps, warm=1) / n


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
    from concurrent.futures import ThreadPoolExecutor

    from sfmx_torch.kernels import _build
    from sfmx_torch.recon import _native_tracks

    t0 = time.perf_counter()
    libs = ("scale_space", "describe", "match_top2", "match_pairs", "ba")
    # one nvcc per source and the track builder's g++, all together, so no
    # build lands in a measured stage
    with ThreadPoolExecutor(len(libs) + 1) as ex:
        futures = [ex.submit(_build.load, lib) for lib in libs]
        futures.append(ex.submit(_native_tracks._lib))
        for f in futures:
            f.result()
    log(f"[build] {time.perf_counter() - t0:.2f} s (nvcc per library: "
        f"{json.dumps({k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()})}; "
        f"native/tracks.cpp with g++ beside them)")


def k3_read_bytes(levels, kp) -> int:
    """The level bytes K3 must read for these keypoints: the union over the
    batch's unmasked keypoints of the 2x2 neighbourhoods of their 24x24
    samples, inside the level (the zero padding is not read).  The sampling
    is separable, so a keypoint touches the outer product of its 48 sampled
    rows and 48 sampled columns."""
    import torch

    from sfmx_torch.kernels import describe as dsc

    B, L, H, W = levels.shape
    K = kp.uv.shape[1]
    Hp, Wp = dsc.padded_size(H, W)
    y0, x0, fy, fx, sp = dsc._window_params(kp.uv, kp.sigma, Hp, Wp)
    off = (torch.arange(24, dtype=torch.float32, device=levels.device) - 11.5) * sp[..., None]
    xs = torch.clamp(x0.float()[..., None] + fx[..., None] + off, 0.0, Wp - 1.001)
    ys = torch.clamp(y0.float()[..., None] + fy[..., None] + off, 0.0, Hp - 1.001)
    cols = torch.stack([torch.floor(xs), torch.floor(xs) + 1], -1).long().reshape(B, K, 48)
    rows = torch.stack([torch.floor(ys), torch.floor(ys) + 1], -1).long().reshape(B, K, 48)
    plane = (torch.arange(B, device=levels.device)[:, None] * L + kp.level.long())   # (B,K)
    idx = ((plane[..., None] * H + rows)[..., :, None] * W + cols[..., None, :])
    ok = (kp.mask[..., None, None] & (rows < H)[..., :, None] & (cols < W)[..., None, :])
    seen = torch.zeros(B * L * H * W, dtype=torch.bool, device=levels.device)
    seen[idx[ok]] = True
    return int(seen.sum()) * 4


def phase_kernels(images, dev, profile: bool = False) -> dict:
    """K1-K3 vs their plain versions on a batch of the main path's inputs
    (both octaves); returns octave 0's times and the larger error.  With
    ``profile`` also K3's device time per call by torch.profiler."""
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
        b2b3 = cuda_ms_per_call(lambda: dsc.describe_upright(*args))
        dev3 = ""
        if profile:
            ms_dev, note = launch_device_ms(lambda: dsc.describe_upright(*args), 10)
            dev3 = f", device {ms_dev:.4f} ms per call by torch.profiler ({note})"
        log(f"[kernels] describe_upright B={B} {H}x{W} K={K}: {b2b3:.4f} ms per call by CUDA events "
            f"around 20 calls back to back{dev3}")
        shape = f"B={B} {H}x{W} L={cfg.n_levels} K={K}"
        # necessary work: K1 reads and writes one level per segment and does
        # ~30 FLOP per pixel and FED step (4 differences, 4 conductivities
        # with a division each, the flux sum, the update); K2 reads the
        # levels and writes one response each (~15 FLOP per pixel: three
        # second differences and the determinant); K3 reads the level pixels
        # its keypoints' 24x24 bilinear samples touch (each once) plus 5
        # keypoint fields, does ~12 FLOP a sample, and writes 128 floats per
        # keypoint
        px, nl = B * H * W, levels.shape[1]
        n_kp = int(kp.mask.sum())
        bounds = {
            "diffuse_segment": bound(len(segs) * 2 * px * 4, 30.0 * px * sum(map(len, segs)), "f32"),
            "response_levels": bound(2 * nl * px * 4, 15.0 * nl * px, "f32"),
            "describe_upright": bound(k3_read_bytes(levels, kp) + B * K * (128 + 5) * 4,
                                      12.0 * 576 * n_kp, "f32"),
        }
        for name, err in errs.items():
            tol = KERNELS[name][2]
            ms, pms = times[name]
            log(f"[kernels] {name:17s} {shape}: max_abs_err {err:.3e} (tol {tol:.0e}); "
                f"kernel {ms:.3f} ms, plain {pms:.3f} ms"
                + (" (all 4 segments)" if name == "diffuse_segment" else ""))
            assert err <= tol, f"{name} at {shape}: max_abs_err {err} > {tol}"
            if octave == 0:
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bounds[name]}
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
    desc = feats.desc.cpu().numpy()
    scene, obs_feat = smoke_scenes.room_scene(poses, uv, mask, INTR, room.ROOM)
    lmap = build_localization_map(scene, desc, obs_feat, dev, kp_mask=mask, n_words=64,
                                  seed=0, feat_bits=feats.desc_bits.cpu().numpy())
    P = lmap.X.shape[0]
    assert lmap.vocab is not None, "map has no VLAD vocabulary"
    assert lmap.lm_bits is not None, "map has no landmark bits"
    assert P < cfg.localize.streaming_min_landmarks, f"{P} landmarks would need streaming"
    log(f"[map] {N_KEYFRAMES} keyframes rendered in {t_render:.1f} s; "
        f"{int(mask.sum())} keypoints -> {P} landmarks, vocab {tuple(lmap.vocab.shape)}")
    return lmap, (poses, desc, uv, mask)


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


def phase_rate(extract, localize, n_frames: int, smi: str, reps: int = 5,
               label: str = "query path") -> float:
    """Steady-state frames/s on the device: extraction + localize.
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
    log(f"[rate] {label} B={n_frames} {H_IMG}x{W_IMG}: {n_frames / wall:.2f} frames/s "
        f"(median {wall * 1e3:.2f} ms per batch of {reps}; extraction {ms_extract:.2f} ms, "
        f"localization {ms_localize:.2f} ms by CUDA events) on {smi}")
    return wall


def device_ms_per_run(fn, reps: int, counts: dict | None = None):
    """Run fn() reps times under torch.profiler.  Returns the device time per
    run in ms (the summed durations of every kernel, copy and fill the trace
    holds; the path runs on one stream, so they do not overlap; fn must not
    open a record_function range, whose device-side annotation would count
    as well), the device
    time per run of each kernel name, and the profiler's table; ``counts``,
    where given, receives the number of traced events of each name.  A trace
    without any device event is taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # now and then a trace comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        seen: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
                seen[e.name] = seen.get(e.name, 0) + 1
        if by_name:
            break
    if counts is not None:
        counts.update(seen)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    return sum(by_name.values()), by_name, table


def launch_device_ms(fn, reps: int) -> tuple[float, str]:
    """Device time per call of a wrapper that launches each of its kernels
    once a call: the mean traced duration of each kernel, summed over its
    kernels (a trace that lost launches still times those it holds), and a
    note of each kernel's mean and how many of its reps launches the trace
    holds."""
    counts: dict[str, int] = {}
    _ms, by_name, _table = device_ms_per_run(fn, reps, counts)
    means = {k: t * reps / counts[k] for k, t in by_name.items()}
    note = ", ".join(f"{t:.4f} {k.replace('(anonymous namespace)::', '').split('(')[0]} "
                     f"({counts[k]} of {reps} traced)" for k, t in means.items())
    return sum(means.values()), note


def phase_profile(stages: dict, wall: float, smi: str, tag: str, n_frames: int,
                  reps: int = 3):
    """Device time of each stage and of the whole path under torch.profiler,
    and the device's busy share of the unprofiled wall time per batch.  The
    full table goes to chiprun_out/profile_<tag>.txt."""
    def path():
        for fn in stages.values():
            fn()

    ms = {k: device_ms_per_run(fn, reps)[0] for k, fn in stages.items()}
    ms_p, by_name, table = device_ms_per_run(path, reps)
    assert ms_p > 0, "the profiler recorded no device time"
    log(f"[profile] {tag} B={n_frames}: device time per batch (torch.profiler, {reps} "
        f"batches each): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f", whole path {ms_p:.3f} ms; wall per batch without the profiler "
        f"{wall * 1e3:.2f} ms; device busy {ms_p / (wall * 1e3):.3f} of it, on {smi}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {t:8.3f} ms  {name[:100]}")
    out = ROOT / "chiprun_out" / f"profile_{tag}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(f"{smi}\n{tag} path, whole path, {reps} batches\n{table}\n")


# ---------------------------------------------------------------------------
# Tracking, P3P and binary matching on the 24-keyframe map
# ---------------------------------------------------------------------------


def _gate(tag: str, results, poses, min_localized: int) -> float:
    errs = [float(np.linalg.norm(np.asarray(r["center"]) - eye))
            for r, (_R, _t, eye) in zip(results, poses)]
    assert all(np.isfinite(errs)), f"{tag}: non-finite pose"
    med = float(np.median(errs))
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[{tag}] median center error {med:.4f} m (gate < {MEDIAN_GATE_M}); "
        f"{n_conf}/{len(results)} with confidence > 0 (gate >= {min_localized})")
    assert med < MEDIAN_GATE_M, f"{tag}: median center error {med} m"
    assert n_conf >= min_localized, f"{tag}: only {n_conf} localized"
    return med


def phase_tracking(frames, lmap, dev):
    """The 16 held-out frames, in walk order, as one tracked sequence."""
    import dataclasses

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images, localize_sequence_images

    poses = query_poses()
    t0 = time.perf_counter()
    out = localize_sequence_images(frames, INTR, lmap, PipelineConfig(),
                                   generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    n_tracked = sum(f["tracked"] for f in out["frames"])
    log(f"[tracking] {len(frames)} frames in {time.perf_counter() - t0:.2f} s: "
        f"stats {json.dumps(out['stats'])}, {n_tracked} tracked (gate >= {len(frames) - 4})")
    assert n_tracked >= len(frames) - 4, f"only {n_tracked} frames tracked"
    _gate("tracking", out["frames"], poses, len(frames) - 4)

    cfg = PipelineConfig()
    for tag, lc in (("p3p", dataclasses.replace(cfg.localize, pnp_solver="p3p")),
                    ("binary", dataclasses.replace(cfg.localize, binary=True))):
        res = localize_images(frames, INTR, lmap, dataclasses.replace(cfg, localize=lc),
                              generator=torch.Generator(device=dev).manual_seed(6))
        _gate(tag, res, poses, 12)


# ---------------------------------------------------------------------------
# Map-scale serving on K4
# ---------------------------------------------------------------------------


def phase_map_scale(kf, dev):
    """The query room's 24 keyframes merged to one landmark per surface
    cell, plus distractor rooms (other RoomTexture seeds, 24 keyframes
    each, one landmark per keypoint, translated 20 m apart along x) until
    the map holds >= MAP_SCALE_LANDMARKS landmarks."""
    from examples import room

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import build_localization_map, use_streaming
    from tests import smoke_scenes

    t0 = time.perf_counter()
    poses, desc, uv, mask = kf
    cfg = PipelineConfig()
    scene, obs_feat = smoke_scenes.merged_room_scene(poses, uv, mask, INTR, room.ROOM)
    n_query_room = len(scene["X"])
    parts, descs, masks = [(scene, obs_feat, np.zeros(3))], [desc], [mask]
    P, t_render, room_id = n_query_room, 0.0, 0
    while P < MAP_SCALE_LANDMARKS:
        room_id += 1
        t1 = time.perf_counter()
        frames = smoke_scenes.render_parallel(1000 + room_id, poses, W_IMG, H_IMG, FOCAL,
                                              RENDER_WORKERS)
        t_render += time.perf_counter() - t1
        f = extract_features(frames, cfg, dev)
        m = f.kp.mask.cpu().numpy()
        sc, of = smoke_scenes.room_scene(poses, f.kp.uv.cpu().numpy(), m, INTR, room.ROOM)
        parts.append((sc, of, np.array([20.0 * room_id, 0.0, 0.0])))
        descs.append(f.desc.cpu().numpy())
        masks.append(m)
        P += len(sc["X"])
    cols, obs = smoke_scenes.combine_scenes(parts)
    lmap = build_localization_map(cols, np.concatenate(descs), obs, dev,
                                  kp_mask=np.concatenate(masks), n_words=64, seed=0)
    P = lmap.X.shape[0]
    assert P >= MAP_SCALE_LANDMARKS and use_streaming(cfg.localize, lmap, binary=False), P
    log(f"[map-scale] query room {N_KEYFRAMES} keyframes -> {n_query_room} merged landmarks "
        f"(1.5 cm cells); {room_id} distractor rooms x {N_KEYFRAMES} keyframes rendered in "
        f"{t_render:.1f} s ({RENDER_WORKERS} processes); map {P} landmarks, "
        f"{lmap.kf_gdesc.shape[0]} keyframes, streaming=auto picks K4; "
        f"phase {time.perf_counter() - t0:.1f} s")
    return lmap


def serve_poses():
    """Held-out poses of the query room, none equal to a keyframe pose."""
    from examples import room

    return room.walk_poses(2 * N_SERVE + 1)[1::2]


def phase_k4(lmap, frames, dev, smi: str, profile: bool) -> dict:
    """K4 against its plain version at the serving run's two shapes: the
    first batch's query descriptors (32 x 1024 rows) and the burst's tail (2
    x 1024 rows, where the kernel splits the landmark loop), each against
    the whole pool, padded and masked as ``match_float_streaming`` does.  At
    the tail the split result must equal the unsplit one bit for bit.  With
    ``profile`` also what the streaming matcher adds around the kernel."""
    import torch
    import torch.nn.functional as TF

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.core.masking import round_up
    from sfmx_torch.kernels import match as mt

    f = extract_features(frames[:SERVE_BATCH], PipelineConfig(), dev)
    B, K, D = f.desc.shape
    a_all = torch.where(f.kp.mask.reshape(-1)[:, None], f.desc.reshape(B * K, D), 0.0)
    b = torch.where(lmap.lm_alive[:, None], lmap.lm_desc, 0.0)
    b = TF.pad(b, (0, 0, 0, round_up(b.shape[0], 2048) - b.shape[0]))
    tol = KERNELS["match_top2"][2]
    out = {}
    for tag, n_img in (("batch", SERVE_BATCH), ("tail", N_TAIL)):
        a = a_all[:n_img * K]
        a = TF.pad(a, (0, 0, 0, round_up(a.shape[0], 256) - a.shape[0]))
        Ka, Kb = a.shape[0], b.shape[0]
        splits = mt.split_plan(Ka, Kb)[0]
        got = mt.match_top2(a, b)
        ref = mt.match_top2_plain(a, b)
        torch.cuda.synchronize()
        err = max(float((got[0] - ref[0]).abs().max()), float((got[2] - ref[2]).abs().max()))
        clear = (ref[0] - ref[2]) > tol
        bad = int((got[1] != ref[1])[clear].sum())
        near = int((got[1] != ref[1])[~clear].sum())
        other = mt.match_top2(a, b, splits=1 if splits > 1 else 8)
        same = all(torch.equal(x, y) for x, y in zip(got, other))
        ms = cuda_ms(lambda: mt.match_top2(a, b))
        # the launches alone: the wrapper's casts of both sides to bf16 done before
        a16, b16 = a.to(torch.bfloat16).contiguous(), b.to(torch.bfloat16).contiguous()
        lms = cuda_ms(lambda: mt._match_top2_cuda(a16, b16))
        pms = cuda_ms(lambda: mt.match_top2_plain(a, b), reps=3, warm=1)
        flop = 2.0 * Ka * Kb * 128
        bnd = bound((Ka + Kb) * 128 * 2 + Ka * 12, flop, "bf16")
        log(f"[K4] match_top2 {tag} {tuple(a.shape)} x {tuple(b.shape)} bf16, {splits} split(s), "
            f"{mt.match_top2_launches(Ka, Kb)} launch(es): max_abs_err {err:.3e} (tol {tol:.0e}); "
            f"index mismatches {bad} outside near-ties ({int(clear.sum())} rows), {near} among "
            f"{int((~clear).sum())} near-tie rows; equal to the "
            f"{'unsplit' if splits > 1 else '8-split'} result bit for bit: {same}; kernel "
            f"{ms:.3f} ms with the wrapper's bf16 casts, {lms:.3f} ms on bf16 inputs "
            f"({flop / lms / 1e9:.1f} TFLOP/s), bound {bnd['bound_ms']:.3f} ms by "
            f"{bnd['bound_by']}, plain {pms:.3f} ms; on {smi}")
        assert err <= tol, f"match_top2 {tag}: max_abs_err {err} > {tol}"
        assert bad == 0, f"match_top2 {tag}: {bad} index mismatches outside near-ties"
        assert same, f"match_top2 {tag}: split and unsplit results differ"
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "splits": splits,
                    "launch_ms": lms, **bnd}
    assert out["tail"]["splits"] > 1 and out["batch"]["splits"] == 1, out
    if profile:
        phase_k4_wrapper(f.desc.reshape(B * K, D), f.kp.mask.reshape(-1), lmap, smi)
    tail = out["tail"]
    return {**out["batch"], "max_abs_err": max(out["batch"]["max_abs_err"], tail["max_abs_err"]),
            "splits": tail["splits"], "tail_ms": tail["ms"], "tail_bound_ms": tail["bound_ms"],
            "tail_plain_ms": tail["plain_ms"], "tail_launch_ms": tail["launch_ms"]}


def phase_k4_wrapper(desc, mask, lmap, smi: str, reps: int = 5) -> None:
    """What ``match_float_streaming`` adds around K4 on one serving batch:
    it masks, pads and casts the queries and the whole pool on every call.
    Device ms by torch.profiler (the kernel's own beside everything else) and
    the host's median time to enqueue one call on an idle card."""
    import torch

    from sfmx_torch.kernels import match as mt

    def call():
        mt.match_float_streaming(desc, lmap.lm_desc, mask, lmap.lm_alive, ratio=0.85)

    ms_all, by_name, _table = device_ms_per_run(call, reps)
    ms_k4 = sum(t for name, t in by_name.items() if "match_top2" in name or "merge_splits" in name)
    torch.cuda.synchronize()
    host = []
    for _ in range(4 * reps):
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()      # so that no call waits for room in the launch queue
    host_us = float(np.median(host)) * 1e6
    top = sorted(((t, k) for k, t in by_name.items() if "match_top2" not in k), reverse=True)[:4]
    log(f"[profile] match_float_streaming {tuple(desc.shape)} x {tuple(lmap.lm_desc.shape)}: "
        f"device {ms_all:.3f} ms per call, of it K4 {ms_k4:.3f} ms and the wrapper's masking, "
        f"padding and casts {ms_all - ms_k4:.3f} ms in {len(by_name) - 1} other device ops ("
        + "; ".join(f"{t:.3f} ms {k[:50]}" for t, k in top)
        + f"); host {host_us:.1f} us per call; on {smi}")


def phase_serve(lmap, frames, own_frames, dev, smi: str) -> dict:
    """Concurrent image requests through the service on the map-scale map.
    Returns the kernel launches of the serving run."""
    import asyncio

    import torch

    import sfmx_torch.serve.server as server
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.core.masking import round_up
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.localize.fusion import BeaconPrior
    from sfmx_torch.localize.localize import use_streaming

    cfg = PipelineConfig()
    svc = server.LocalizationService(batch_window_ms=SERVE_WINDOW_MS, max_batch=SERVE_BATCH)
    svc.load_map("building", lmap, INTR, cfg=cfg)
    t0 = time.perf_counter()
    svc.warmup("building")
    log(f"[serve] warmup (one batch of {SERVE_BATCH} blank images) {time.perf_counter() - t0:.2f} s")
    # every batch is one (map, K, non-binary) group on the streaming path,
    # so each batch is one streaming localize call
    assert use_streaming(cfg.localize, lmap, binary=False)
    poses = serve_poses()
    own_intr = np.array([FOCAL_OWN, FOCAL_OWN, W_IMG / 2, H_IMG / 2, 0, 0, 0], np.float32)
    rng = np.random.default_rng(11)
    reqs = []
    for i, (_R, _t, eye) in enumerate(poses):
        prior = None
        if i % 4 == 1:      # a quarter carry a beacon prior ~0.5 m off
            off = rng.normal(size=3)
            prior = BeaconPrior(torch.tensor(eye + 0.5 * off / np.linalg.norm(off),
                                             dtype=torch.float32), 5.0, 0.5)
        reqs.append(dict(image=frames[i], prior=prior))
    reqs += [dict(image=img, intr=own_intr) for img in own_frames]
    eyes = [eye for _R, _t, eye in poses] + [eye for _R, _t, eye in serve_poses()[:len(own_frames)]]

    async def run():
        await svc.start()
        try:
            outs, walls = [], []
            for _ in range(N_BURSTS):
                t0 = time.perf_counter()
                outs += await asyncio.gather(*[svc.localize("building", **r) for r in reqs])
                walls.append(time.perf_counter() - t0)
            return outs, walls
        finally:
            await svc.stop()

    # the query rows of every streaming call the service makes, so that the
    # K4 launches can be held against what the wrapper says each call takes
    streaming, k4_rows = server.localize_batch_streaming, []

    def recording(lmap_, q_desc, *args, **kw):
        k4_rows.append(q_desc.shape[0] * q_desc.shape[1])
        return streaming(lmap_, q_desc, *args, **kw)

    server.localize_batch_streaming = recording
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    try:
        outs, walls = asyncio.run(run())
    finally:
        server.localize_batch_streaming = streaming
    launches = dict(_build.LAUNCHES.counts)
    Kb = round_up(lmap.lm_desc.shape[0], 2048)
    k4_expected = sum(mt.match_top2_launches(round_up(max(r, 256), 256), Kb) for r in k4_rows)

    n = len(outs)
    eyes, reqs_all = eyes * N_BURSTS, reqs * N_BURSTS
    errs = np.array([np.linalg.norm(np.asarray(o["center"]) - e) for o, e in zip(outs, eyes)])
    # localized = the vision pose passed (n_inliers >= min_inliers, i.e. its
    # confidence > 0); the returned confidence is the beacon-fused one
    n_loc = sum(o["n_inliers"] >= cfg.localize.min_inliers for o in outs)
    st = svc.stats.snapshot()
    for i in range(0, len(reqs), 8):
        log(f"[serve] {i:2d}: center error {errs[i]:.4f} m, {outs[i]['n_inliers']} inliers, "
            f"confidence {outs[i]['confidence']:.3f}, source {outs[i]['source']}")
    own = np.concatenate([errs[b * len(reqs) + N_SERVE:(b + 1) * len(reqs)]
                          for b in range(N_BURSTS)])
    log(f"[serve] {N_BURSTS} bursts of {len(reqs)} requests "
        f"({sum(r.get('prior') is not None for r in reqs)} with a beacon prior, "
        f"{len(own_frames)} with own intrinsics f={FOCAL_OWN:g}: max error {own.max():.4f} m); "
        f"burst walls {', '.join(f'{w:.3f}' for w in walls)} s; {n} requests in "
        f"{sum(walls):.3f} s = {n / sum(walls):.2f} requests/s; {st['batches']} batches, "
        f"mean batch {st['mean_batch_size']:.2f}; latency over all {n} requests p50 "
        f"{st['p50_latency_ms']:.1f} ms, p95 {st['p95_latency_ms']:.1f} ms, p99 "
        f"{st['p99_latency_ms']:.1f} ms; median center error {np.median(errs):.4f} m "
        f"(gate < {MEDIAN_GATE_M}); {n_loc}/{n} localized by vision; on {smi}")
    log(f"[serve] launches {json.dumps(launches)}; {len(k4_rows)} streaming calls with query rows "
        f"{json.dumps({str(r): k4_rows.count(r) for r in sorted(set(k4_rows))})}, which take "
        f"{k4_expected} K4 launches (a call that splits the landmark loop takes 2)")
    assert np.isfinite(errs).all(), "serve: non-finite pose"
    assert np.median(errs) < MEDIAN_GATE_M, f"serve: median center error {np.median(errs)}"
    assert n_loc >= 0.75 * n, f"serve: only {n_loc}/{n} localized"
    assert st["requests"] == n and st["batches"] < n, st
    assert len(k4_rows) == st["batches"], (k4_rows, st)
    assert launches.get("match_top2", 0) == k4_expected, (launches, k4_expected)
    assert np.all(own < MEDIAN_GATE_M), f"serve: own-intrinsics requests off by {own}"
    assert all((o["source"] == 0) == (r.get("prior") is None)
               for o, r in zip(outs, reqs_all)), "serve: unexpected fusion sources"
    return launches


def streaming_path(frames, lmap, dev):
    """Extraction + ``localize_batch_streaming`` on one device-resident
    B=32 batch, as two closures (the serving path without the queue)."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features
    from sfmx_torch.localize.localize import localize_batch_streaming

    cfg = PipelineConfig()
    lc = cfg.localize
    imgs = torch.as_tensor(frames[:SERVE_BATCH], device=dev)
    intr = torch.as_tensor(INTR, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    state = {}

    def extract():
        state["f"] = extract_features(imgs, cfg, dev)

    def localize():
        f = state["f"]
        localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask, intr, generator=gen,
                                 k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
                                 sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers)

    extract()
    return extract, localize, state


def phase_streaming_crosscheck(lmap, state, dev):
    """One B=32 streaming batch on the card and on the CPU's plain path
    (plain K4 included) with the same features and RANSAC noise: centers
    within 3 cm, as phase 5 states for the gather path."""
    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.localize.localize import LocalizationMap, localize_batch_streaming
    from sfmx_torch.solvers.ransac import gumbel_noise

    lc = PipelineConfig().localize
    f = state["f"]
    B, K, _ = f.desc.shape
    g = gumbel_noise((B, lc.k_hypotheses, K), device="cpu",
                     generator=torch.Generator().manual_seed(4))
    kw = dict(k_hypotheses=lc.k_hypotheses, px_thresh=lc.px_thresh,
              sim_thresh=lc.sim_thresh, min_inliers=lc.min_inliers)
    card = localize_batch_streaming(lmap, f.desc, f.kp.uv, f.kp.mask,
                                    torch.as_tensor(INTR, device=dev), gumbel=g.to(dev), **kw)
    t0 = time.perf_counter()
    cpu_map = LocalizationMap(*(None if x is None else x.cpu() for x in lmap))
    plain = localize_batch_streaming(cpu_map, f.desc.cpu(), f.kp.uv.cpu(), f.kp.mask.cpu(),
                                     torch.as_tensor(INTR), gumbel=g, **kw)
    t_cpu = time.perf_counter() - t0
    dc = torch.linalg.vector_norm(card.center.cpu() - plain.center, dim=-1)
    dn = (card.n_inliers.cpu() - plain.n_inliers).abs()
    log(f"[streaming] B={B} card vs plain CPU path ({t_cpu:.1f} s on the CPU): centers "
        f"max {float(dc.max()):.2e} m apart (gate < 0.03), inliers max |diff| {int(dn.max())} "
        f"of {int(plain.n_inliers.min())}..{int(plain.n_inliers.max())}")
    assert float(dc.max()) < 0.03, f"streaming card vs plain centers {float(dc.max())} m apart"


# ---------------------------------------------------------------------------
# Map-build front end on K5, K9 and K10
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_matcher_calls():
    """Record the device of every call of the plain pair matcher (in each
    module that holds a reference to it) while the block runs."""
    from sfmx_torch.kernels import matching, pairs, tiles

    calls: list[str] = []
    orig = matching.match_pairs_float

    def counted(descs, *args, **kw):
        calls.append(descs.device.type)
        return orig(descs, *args, **kw)

    mods = (matching, pairs, tiles)
    for m in mods:
        m.match_pairs_float = counted
    try:
        yield calls
    finally:
        for m in mods:
            m.match_pairs_float = orig


def run_front_end(tag: str, images, cfg, dev, feats=None):
    """One build through ``build_front_end`` (extract, pairs, match, verify,
    tracks), the launch counts set to 0 just before it and read just after.
    Gates: the plain matcher never ran on the card.  Returns
    ((feats, pairs, verified MatchResult, inlier counts, TrackTable),
    launches, the stage records)."""
    import io

    import torch

    from sfmx_torch.cli.pipeline import build_front_end
    from sfmx_torch.kernels import _build
    from sfmx_torch.utils.logging import LOGGER

    n = len(images) if images is not None else feats.desc.shape[0]
    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        with plain_matcher_calls() as plain:
            torch.cuda.synchronize()
            _build.LAUNCHES.reset()
            t0 = time.perf_counter()
            out = build_front_end(images, INTR[None], np.zeros(n, np.int32), cfg, dev,
                                  feats=feats, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES.counts)
    finally:
        LOGGER._stream = old
    stages = {r["stage"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    pairs = out[1]
    m, v = stages["match"], stages["geometric_verify"]
    log(f"[{tag}] {n} frames, {len(pairs)} pairs ({cfg.match.pair_mode}, kernel "
        f"{'hamming' if cfg.match.binary else cfg.match.kernel}): stage wall "
        + ", ".join(f"{k} {r['wall_s']:.3f} s" for k, r in stages.items())
        + f"; whole {wall:.3f} s; matching {len(pairs) / m['wall_s']:.1f} pairs/s, "
        f"verification {len(pairs) / v['wall_s']:.1f} pairs/s; {m['matches']} matches -> "
        f"{v['inliers']} inliers, {v['pairs_kept']} pairs kept, {stages['tracks']['tracks']} "
        f"tracks; launches {json.dumps(launches)}; plain matcher calls {plain}")
    assert "cuda" not in plain, f"{tag}: the plain matcher ran on the card"
    return out, launches, stages


def truth_gates(tag: str, poses, front, min_inliers: int) -> None:
    """The verified matches and tracks against the raycast truth: every
    keypoint's surface point on the room box at its frame's true pose.

    A keypoint is located to a fraction of its scale sigma (2-12 px at full
    resolution), and at the room's 8-9 m one pixel spans ~1.5 cm, so two
    views of one surface point can sit a few cm apart.  The tolerance of a
    keypoint is therefore the larger of TRUTH_M and its footprint, sigma
    projected to its surface point's depth.  A match is true when its two
    surface points lie within the larger tolerance of its two keypoints; a
    track observation is true when it lies within its own tolerance of the
    track's median point, and a track pure when all of its observations
    are.  Gates: true matches >= TRUTH_SHARE, true track observations >=
    TRACK_OBS_SHARE, and the track table equal to the numpy union-find's
    on the same matches.  The conflict-aware union-find chains tracks
    through dense match graphs (the reference's builder gives the same
    table), so one stray observation makes a long track impure: the share
    of pure tracks is printed, with the shares within TRUTH_M alone."""
    from examples import room
    from sfmx_torch.recon.tracks import build_tracks
    from tests.smoke_scenes import raycast_room

    feats, pairs, res, cnt, tt = front
    uv = feats.kp.uv.cpu().numpy().astype(np.float64)
    X = np.stack([raycast_room(R, eye, uv[c], INTR, room.ROOM)
                  for c, (R, _t, eye) in enumerate(poses)])            # (C,K,3)
    eyes = np.stack([eye for _R, _t, eye in poses])
    foot = feats.kp.sigma.cpu().numpy() * np.linalg.norm(X - eyes[:, None], axis=-1) / FOCAL
    tol = np.maximum(TRUTH_M, foot)                                    # (C,K)
    idx, valid = res.idx.cpu().numpy(), res.valid.cpu().numpy()
    p, r = np.nonzero(valid)
    a, b, j = pairs[p, 0], pairs[p, 1], idx[p, r]
    dist = np.linalg.norm(X[a, r] - X[b, j], axis=1)
    match_ok = float((dist < np.maximum(tol[a, r], tol[b, j])).mean())
    Xo, to = X[tt.obs_cam, tt.obs_feat], tol[tt.obs_cam, tt.obs_feat]
    starts, ends = tt.track_slices()
    dev_m = np.empty(len(Xo))
    for s, e in zip(starts, ends):
        dev_m[s:e] = np.linalg.norm(Xo[s:e] - np.median(Xo[s:e], axis=0), axis=1)
    obs_ok = dev_m < to
    n_t = max(tt.n_tracks, 1)
    pure = np.logical_and.reduceat(obs_ok, starts).sum() if tt.n_tracks else 0
    pure_cm = np.logical_and.reduceat(dev_m < TRUTH_M, starts).sum() if tt.n_tracks else 0
    adj = pairs[:, 1] == pairs[:, 0] + 1
    cnt = cnt.cpu().numpy()
    log(f"[{tag}] truth: {match_ok:.4f} of {len(dist)} verified matches true (gate >= "
        f"{TRUTH_SHARE}; {float((dist < TRUTH_M).mean()):.4f} within {TRUTH_M * 100:.0f} cm, "
        f"{float((dist > 0.3).mean()):.4f} over 30 cm); {float(obs_ok.mean()):.4f} of "
        f"{len(obs_ok)} track observations true (gate >= {TRACK_OBS_SHARE}); {pure}/{tt.n_tracks} "
        f"tracks pure = {pure / n_t:.4f} ({pure_cm / n_t:.4f} within {TRUTH_M * 100:.0f} cm); "
        f"mean track length {np.mean(ends - starts):.2f}; adjacent-frame pairs: min "
        f"{int(cnt[adj].min())} inliers (gate >= {min_inliers}) over {int(adj.sum())}")
    assert len(dist) > 0 and match_ok >= TRUTH_SHARE, f"{tag}: {match_ok} of matches true"
    assert tt.n_tracks > 0 and obs_ok.mean() >= TRACK_OBS_SHARE, \
        f"{tag}: {obs_ok.mean()} of track observations true"
    t0 = time.perf_counter()
    oracle = build_tracks(pairs, idx, valid, len(poses), idx.shape[1], impl="numpy")
    same = all(np.array_equal(x, y) for x, y in zip(oracle[:3], tt[:3]))
    log(f"[{tag}] tracks equal to the numpy union-find's on the same matches: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert same and oracle.n_tracks == tt.n_tracks, f"{tag}: native and numpy tracks differ"
    assert int(cnt[adj].min()) >= min_inliers, f"{tag}: an adjacent pair lost its inliers"


def check_matcher(tag: str, got, ref, near, tol: float = NEAR_TIE) -> float:
    """Kernel against plain on the same pairs: score within tol everywhere,
    valid equal and idx equal on accepted rows outside near-ties."""
    err = float((got.score - ref.score).abs().max())
    clear = ~near
    bad_v = int((got.valid != ref.valid)[clear].sum())
    bad_i = int((got.idx != ref.idx)[clear & ref.valid].sum())
    log(f"[{tag}] max_abs_err {err:.3e} (tol {tol:.0e}); valid mismatches {bad_v}, idx "
        f"mismatches {bad_i} outside near-ties; {int(near.sum())} near-tie rows of "
        f"{near.numel()}; {int(ref.valid.sum())} accepted by the plain version")
    assert err <= tol and bad_v == 0 and bad_i == 0, f"{tag} disagrees with its plain version"
    return err


def phase_pair_kernels(feats, pairs, band_feats, band_pairs, ratio: float, smi: str) -> dict:
    """K5 and K9 against the plain matcher at the exhaustive build's 4,560
    pairs, K9 against K5 (exactly) and the plain matcher on the band build's
    list, each kernel's time beside the plain version's."""
    import torch

    from sfmx_torch.kernels.matching import match_pairs_float
    from sfmx_torch.kernels.pairs import match_pairs_fused
    from sfmx_torch.kernels.tiles import match_pairs_float_tiled
    from tests.smoke_scenes import pair_near_ties

    out = {}
    errs9 = []
    for tag, f, p in (("exhaustive", feats, pairs), ("band", band_feats, band_pairs)):
        d, m = f.desc, f.kp.mask
        k5 = match_pairs_fused(d, m, p, ratio=ratio)
        k9 = match_pairs_float_tiled(d, m, p, ratio=ratio)
        ref = match_pairs_float(d, m, p, ratio=ratio)
        near = pair_near_ties(d, m, p, ratio, NEAR_TIE)
        err5 = check_matcher(f"K5 {tag} {len(p)} pairs", k5, ref, near)
        errs9.append(check_matcher(f"K9 {tag} {len(p)} pairs", k9, ref, near))
        same = all(torch.equal(x, y) for x, y in zip(k9, k5))
        log(f"[K9 {tag}] equal to K5 in every field: {same}")
        assert same, f"K9 and K5 differ on the {tag} pairs"
        w5 = cuda_ms(lambda: match_pairs_fused(d, m, p, ratio=ratio))
        w9 = cuda_ms(lambda: match_pairs_float_tiled(d, m, p, ratio=ratio))
        ms5 = kernel_ms(lambda: match_pairs_fused(d, m, p, ratio=ratio))
        ms9 = kernel_ms(lambda: match_pairs_float_tiled(d, m, p, ratio=ratio))
        pms = cuda_ms(lambda: match_pairs_float(d, m, p, ratio=ratio), reps=3, warm=1)
        K = d.shape[1]
        flop = 2.0 * len(p) * K * K * 128
        log(f"[pair kernels] {tag} {len(p)} pairs K={K}: kernels' device time K5 {ms5:.3f} ms "
            f"({len(p) / ms5 * 1e3:.0f} pairs/s, {flop / ms5 / 1e9:.1f} TFLOP/s), K9 {ms9:.3f} ms "
            f"({len(p) / ms9 * 1e3:.0f} pairs/s); whole wrapper call K5 {w5:.3f} ms, K9 {w9:.3f} ms "
            f"(host tile packing included); plain {pms:.3f} ms ({len(p) / pms * 1e3:.0f} "
            f"pairs/s) on {smi}")
        # necessary work: every image's descriptors read once (bf16), one
        # (idx, valid, score) row per pair and keypoint written
        bnd = bound(d.shape[0] * K * 128 * 2 + len(p) * K * 9, flop, "bf16")
        if tag == "exhaustive":
            out["match_pairs_fused"] = {"max_abs_err": err5, "ms": ms5, "plain_ms": pms, **bnd}
        else:
            out["match_pairs_tiled"] = {"max_abs_err": max(errs9), "ms": ms9, "plain_ms": pms,
                                        **bnd}
    return out


def kernel_ms(fn, reps: int = 5) -> float:
    """Device time per call of match_pairs.cu's two kernels (the pair
    kernel and its finish) under torch.profiler, without the wrapper's host
    work and its small device ops."""
    _, by_name, _ = device_ms_per_run(fn, reps)
    return sum(t for k, t in by_name.items() if "pairs_kernel" in k or "finish_kernel" in k)


def phase_k10(feats, pairs, dev, smi: str) -> dict:
    """K10 (K5's raw mode) on the first N_K10_PAIRS exhaustive pairs, masked
    rows zeroed as its callers do: its own path (the raw per-pair top-2
    entry, launch counts set to 0 before it and read after), then against
    its plain version: s1/s2 within the tolerance, i1 equal where the row's
    best two columns differ by more than it, j1 where the column's best two
    rows do."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels.matching import _bf16_sim
    from sfmx_torch.kernels.pairs import match_pairs_top2, match_pairs_top2_plain

    d = torch.where(feats.kp.mask[..., None], feats.desc, 0.0)
    p = pairs[:N_K10_PAIRS]
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    s1, i1, s2, j1 = match_pairs_top2(d, p)
    torch.cuda.synchronize()
    check_launches("K10 path", dict(_build.LAUNCHES.counts), {"match_pairs_top2": 2})
    launches = _build.LAUNCHES.get("match_pairs_top2")
    r1, ri, r2, rj = match_pairs_top2_plain(d, p)
    pt = torch.as_tensor(p, device=dev).long()
    gaps = []                                  # each column's best two rows, 64 pairs at a time
    for s in range(0, len(pt), 64):
        v = torch.topk(_bf16_sim(d[pt[s:s + 64, 0]], d[pt[s:s + 64, 1]]), 2, dim=-2).values
        gaps.append(v[:, 0] - v[:, 1])
    col_gap = torch.cat(gaps)
    tol = KERNELS["match_pairs_top2"][2]
    err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
    row_clear, col_clear = (r1 - r2) > tol, col_gap > tol
    bad_i = int((i1 != ri)[row_clear].sum())
    bad_j = int((j1 != rj)[col_clear].sum())
    ms = kernel_ms(lambda: match_pairs_top2(d, p))
    pms = cuda_ms(lambda: match_pairs_top2_plain(d, p), reps=3, warm=1)
    log(f"[K10] match_pairs_top2 {len(p)} pairs K={d.shape[1]}: max_abs_err {err:.3e} (tol {tol:.0e}); i1 mismatches {bad_i} outside "
        f"{int((~row_clear).sum())} near-tie rows, j1 mismatches {bad_j} outside "
        f"{int((~col_clear).sum())} near-tie columns; kernel {ms:.3f} ms, plain {pms:.3f} ms "
        f"on {smi}")
    assert err <= tol and bad_i == 0 and bad_j == 0, "K10 disagrees with its plain version"
    K = d.shape[1]
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "launches": launches,
            **bound(d.shape[0] * K * 128 * 2 + len(p) * K * 16, 2.0 * len(p) * K * K * 128, "bf16")}


def phase_front_crosscheck(feats, pairs, cfg, dev) -> None:
    """N_XCHECK_PAIRS adjacent-frame pairs: the card's match and verify
    stage outputs against the plain path on the CPU (the card's features
    copied over), with the same injected Gumbel noise.  Match: valid equal
    outside near-ties.  Verify (both fed the card's matches): f32 sums in
    another order (the 8-point batch, the 3x3 SVD) can change which of two
    hypotheses with near-equal counts wins, or whether the refit beats the
    raw winner, and so swap a pair's kept model for one of the same quality;
    a match whose squared Sampson error lies near the threshold may flip
    under any model.  So per pair: inlier counts within XCHECK_SLACK, and
    the inlier masks differ in no more matches than lie within 1% of the
    threshold on either side plus XCHECK_SLACK."""
    import torch

    from sfmx_torch.cli.pipeline import match_images, verify_matches
    from sfmx_torch.core import cameras
    from sfmx_torch.kernels import matching
    from sfmx_torch.kernels.features import Features
    from sfmx_torch.solvers.ransac import gumbel_noise
    from tests.smoke_scenes import pair_near_ties

    sel = pairs[pairs[:, 1] == pairs[:, 0] + 1][:N_XCHECK_PAIRS]
    fc = Features.from_numpy(feats.to_numpy(), "cpu")
    card = match_images(feats, sel, cfg)
    plain = match_images(fc, sel, cfg)
    near = pair_near_ties(fc.desc, fc.kp.mask, sel, cfg.match.ratio, NEAR_TIE)
    bad_v = int((card.valid.cpu() != plain.valid)[~near].sum())
    K, H = feats.desc.shape[1], cfg.match.gv_hypotheses
    g = gumbel_noise((len(sel), H, K), device="cpu", generator=torch.Generator().manual_seed(8))
    cam_k = np.zeros(len(fc.desc), np.int32)
    vc, cc = verify_matches(feats, sel, card, INTR[None], cam_k, cfg, gumbel=g)
    card_cpu = matching.MatchResult(*(x.cpu() for x in card))
    vp, cp = verify_matches(fc, sel, card_cpu, INTR[None], cam_k, cfg, gumbel=g)
    thr = (cfg.match.gv_px_thresh / FOCAL) ** 2
    errs = []
    for f, m, gg in ((fc, card_cpu, g), (feats, card, g.to(dev))):
        xn = cameras.pixel_to_normalized(torch.as_tensor(INTR, device=f.kp.uv.device)[None],
                                         f.kp.uv)
        errs.append(matching.geometric_verify_errors(gg, xn, f.kp.mask, sel, m,
                                                     threshold=thr)[0].cpu() / thr)
    band = ((errs[0] - 1.0).abs() < 0.01) | ((errs[1] - 1.0).abs() < 0.01)
    diff = (vc.valid.cpu() != vp.valid).sum(dim=1)
    dcnt = (cc.cpu() - cp).abs()
    slack = torch.clamp(XCHECK_SLACK * cp, min=2.0)
    fin = torch.isfinite(errs[0]) & torch.isfinite(errs[1]) & card_cpu.valid
    rel = (errs[1] - errs[0]).abs()[fin]
    log(f"[front crosscheck] {len(sel)} adjacent pairs, card vs plain CPU path: match valid "
        f"mismatches {bad_v} outside {int(near.sum())} near-tie rows; verified inlier mask "
        f"differences per pair {diff.tolist()} against {band.sum(dim=1).tolist()} matches within "
        f"1% of the threshold on either side; inlier counts {cp.tolist()} (CPU), max |diff| "
        f"{int(dcnt.max())}; |err card - err cpu| / threshold: median {float(rel.median()):.2e}")
    assert bad_v == 0, "front end: card and CPU matches differ outside near-ties"
    assert bool((dcnt <= slack).all()), "front end: card and CPU inlier counts differ"
    assert bool((diff <= band.sum(dim=1) + slack).all()), "front end: inlier masks differ"


def phase_front_profile(images, feats, pairs, stages: dict, cfg, dev, smi: str) -> None:
    """Device time of the exhaustive build's stages under torch.profiler
    (5 runs each: a window of one ~10 ms match run came back with no device
    events) against their wall times in the unprofiled build.  Each
    stage runs as its body, outside the log scope (a record_function range)
    that build_front_end puts around it."""
    from sfmx_torch.cli.pipeline import extract_features, verify_matches
    from sfmx_torch.kernels.matching import match_pairs_float_auto

    mc = cfg.match
    res = match_pairs_float_auto(feats.desc, feats.kp.mask, pairs, ratio=mc.ratio,
                                 cross_check=mc.cross_check, kernel=mc.kernel)
    n = feats.desc.shape[0]
    runs = {"extract": lambda: extract_features(images, cfg, dev),
            "match": lambda: match_pairs_float_auto(
                feats.desc, feats.kp.mask, pairs, ratio=mc.ratio,
                cross_check=mc.cross_check, kernel=mc.kernel),
            "geometric_verify": lambda: verify_matches(
                feats, pairs, res, INTR[None], np.zeros(n, np.int32), cfg)}
    parts = []
    for stage, fn in runs.items():
        ms, by_name, table = device_ms_per_run(fn, 5)
        assert ms > 0, f"front end {stage}: the profiler recorded no device time"
        wall_ms = stages[stage]["wall_s"] * 1e3
        parts.append(f"{stage} {ms:.3f} ms of {wall_ms:.1f} ms wall (busy {ms / wall_ms:.3f})")
        out = ROOT / "chiprun_out" / f"profile_front_{stage}.txt"
        out.parent.mkdir(exist_ok=True)
        out.write_text(f"{smi}\nexhaustive build, {stage}, 5 runs\n{table}\n")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"[profile] front end {stage}: " + "; ".join(f"{t:.3f} ms {k[:60]}" for k, t in top))
    log(f"[profile] front end B={n}, {len(pairs)} pairs, device time per stage "
        f"(torch.profiler) against the build's stage wall: " + ", ".join(parts)
        + f"; tracks is host work; on {smi}")


def extraction_launches() -> dict:
    """Launches of one extraction call (a chunk of 16 queries, or a whole
    build) through 2 octaves: per octave, K1 one per chunk of fused FED
    steps of its 4 level segments, K2 one (all levels), K3 one."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import scale_space as ss

    fcfg = PipelineConfig().features
    n_oct = fcfg.n_octaves
    n_k1 = sum(len(ss.fused_chunks(taus)) for taus in F.level_taus(
        F.ScaleSpaceConfig(sigma_levels=tuple(fcfg.sigma_levels))))
    return {"diffuse_segment": n_k1 * n_oct, "response_levels": n_oct,
            "describe_upright": n_oct}


def check_launches(tag: str, got: dict, expected: dict) -> None:
    expected = {k: n for k, n in expected.items() if n}
    log(f"[counters] {tag} launches {json.dumps(got)}; expected {json.dumps(expected)}")
    assert got == expected, f"{tag}: launches {got}, expected {expected}"


def phase_front_end(dev, smi: str, profile: bool):
    """Phases 13-15 on a walk across the room and back: its first N_BUILD
    frames exhaustively (K5), all N_BAND frames by retrieval pairs in band
    tiles (K9, the leftovers K5), the first N_BUILD frames' window pairs
    with binary descriptors (plain Hamming matching); then the pair kernels
    against their plain versions and the card against the CPU.  Returns
    (kernel stats, the launches of each kernel's path, the N_BUILD frames
    and their poses)."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.kernels.tiles import pack_tiles
    from tests import smoke_scenes

    t0 = time.perf_counter()
    poses = smoke_scenes.loop_walk_poses(N_BAND)
    frames = smoke_scenes.render_parallel(0, poses, W_IMG, H_IMG, FOCAL, RENDER_WORKERS)
    log(f"[front] {N_BAND} frames of a walk across the room and back rendered in "
        f"{time.perf_counter() - t0:.1f} s ({RENDER_WORKERS} processes)")
    cfg = PipelineConfig()
    mc = cfg.match
    exh, exh_launches, exh_stages = run_front_end("exhaustive", frames[:N_BUILD], cfg, dev)
    assert len(exh[1]) == N_BUILD * (N_BUILD - 1) // 2
    truth_gates("exhaustive", poses[:N_BUILD], exh, mc.gv_min_inliers)

    band_cfg = dataclasses.replace(cfg, match=dataclasses.replace(
        mc, pair_mode="retrieval", window=8, retrieval_k=8, kernel="tiles"))
    band, band_launches, _ = run_front_end("band", frames, band_cfg, dev)
    truth_gates("band", poses, band, mc.gv_min_inliers)
    bp, bcnt = band[1], band[3].cpu().numpy()
    half = N_BAND // 2
    loops = (bp[:, 0] < half) & (bp[:, 1] >= half) & (bp[:, 1] - bp[:, 0] > band_cfg.match.window)
    n_loop_kept = int((bcnt[loops] >= mc.gv_min_inliers).sum())
    _meta, _pos, _dense, rest_idx, n_tiles = pack_tiles(bp, N_BAND)
    log(f"[band] {int(loops.sum())} loop-closure pairs proposed across the two passes, "
        f"{n_loop_kept} kept by verification; {n_tiles} tiles through K9, "
        f"{len(rest_idx)} leftover pairs through K5")
    assert n_loop_kept > 0, "band: no loop closure survived verification"

    bin_cfg = dataclasses.replace(cfg, match=dataclasses.replace(
        mc, pair_mode="window", binary=True))
    binr, bin_launches, _ = run_front_end("binary", None, bin_cfg, dev, feats=exh[0])
    truth_gates("binary", poses[:N_BUILD], binr, mc.gv_min_inliers)

    # K5 and K9 launch twice per wrapper call (the pair kernel, then finish)
    ext = extraction_launches()
    check_launches("exhaustive build", exh_launches, {**ext, "match_pairs_fused": 2})
    check_launches("band build", band_launches,
                   {**ext, "match_pairs_tiled": 2 * (n_tiles > 0),
                    "match_pairs_fused": 2 * (len(rest_idx) > 0)})
    check_launches("binary build", bin_launches, {})

    stats = phase_pair_kernels(exh[0], exh[1], band[0], bp, mc.ratio, smi)
    k10 = phase_k10(exh[0], exh[1], dev, smi)
    stats["match_pairs_top2"] = {k: v for k, v in k10.items() if k != "launches"}
    phase_front_crosscheck(exh[0], exh[1], cfg, dev)
    if profile:
        phase_front_profile(frames[:N_BUILD], exh[0], exh[1], exh_stages, cfg, dev, smi)
    return stats, {"match_pairs_fused": exh_launches.get("match_pairs_fused", 0),
                   "match_pairs_tiled": band_launches.get("match_pairs_tiled", 0),
                   "match_pairs_top2": k10["launches"]}, frames[:N_BUILD], poses[:N_BUILD]


# ---------------------------------------------------------------------------
# Reconstruction: bundle adjustment on K6-K8, build_map, the closed loop
# ---------------------------------------------------------------------------


def rel_err(got, ref) -> float:
    """Largest absolute difference over the reference's largest entry."""
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def ba_kernel_checks(tag: str, prob: dict, tp: int, delta: float, smi: str,
                     profile: bool = False) -> dict:
    """K7, K6 and K8 against their plain versions on the dense layout of one
    problem (tensors on the card under ``ba_solve``'s argument names), with
    their times and bounds; with ``profile`` also K6's and K8's device time
    per call apart from their call times.  Observations past slot tp of a
    point are left out of the layout on both sides."""
    import torch

    from sfmx_torch.kernels import segsum as sg
    from sfmx_torch.solvers import schur

    dev = prob["X"].device
    C, P = prob["R"].shape[0], prob["X"].shape[0]
    dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
    uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
    cam19 = sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"], prob["t"])
    x3 = prob["X"].T.contiguous()
    n_dense = int(dense.cnt.sum())
    out = {}

    # K7
    U, bc, v13, Wp = sg.ba_assemble_fused(cam19, dense, uvw, x3, delta)
    rU, rbc, rv13, rWp = sg.ba_assemble_fused_plain(cam19, dense.camp, uvw, x3, delta)
    torch.cuda.synchronize()
    e7 = {"U": rel_err(U, rU), "V9": rel_err(v13[:9], rv13[:9]), "Wp": rel_err(Wp, rWp),
          "b_c": rel_err(bc, rbc), "b_p": rel_err(v13[9:12], rv13[9:12]),
          "cost": abs(float(v13[12].sum()) - float(rv13[12].sum())) / float(rv13[12].sum())}
    abs7 = max(float((U - rU).abs().max()), float((Wp - rWp).abs().max()),
               float((v13 - rv13).abs().max()), float((bc - rbc).abs().max()))
    tol7 = KERNELS["ba_assemble_fused"][2]
    ms7 = cuda_ms(lambda: sg.ba_assemble_fused(cam19, dense, uvw, x3, delta))
    p7 = cuda_ms(lambda: sg.ba_assemble_fused_plain(cam19, dense.camp, uvw, x3, delta), reps=3, warm=1)
    log(f"[BA kernels] {tag}: K7 ba_assemble_fused C={C} P={P} O={n_dense} tp={tp}: relative errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in e7.items()})} (tol {tol7:.0e} for U, V9, "
        f"Wp, cost; 1e-3 for the near-cancelling b_c, b_p); max abs {abs7:.3e}; kernel "
        f"{ms7:.3f} ms, plain {p7:.3f} ms on {smi}")
    assert max(e7["U"], e7["V9"], e7["Wp"], e7["cost"]) <= tol7 and max(e7["b_c"], e7["b_p"]) <= 1e-3
    # necessary work: uvw, camp, X and the camera table read, W, the point
    # rows and the camera blocks written; ~350 FLOP per observation
    out["ba_assemble_fused"] = {
        "max_abs_err": abs7, "max_rel_err": max(e7.values()), "ms": ms7, "plain_ms": p7,
        **bound(n_dense * (12 + 4 + 72) + P * (12 + 52) + C * (76 + 168), 350.0 * n_dense, "f32")}

    # K6 on the system K7 assembled, bound once as the PCG loop binds it
    vinv = schur._damp_inv3_rows(v13[:9], 1e-4).contiguous()
    xv = torch.randn((6, C), generator=torch.Generator().manual_seed(1)).to(dev)
    cross = sg.SchurMatvec(Wp, dense, vinv)
    z, vy = cross(xv)
    rz, rvy = sg.schur_cross_matvec_plain(Wp, dense.camp, vinv, xv)
    torch.cuda.synchronize()
    e6 = max(rel_err(z, rz), rel_err(vy, rvy))
    abs6 = max(float((z - rz).abs().max()), float((vy - rvy).abs().max()))
    tol6 = KERNELS["schur_cross_matvec"][2]
    ms6 = cuda_ms(lambda: cross(xv), reps=21, warm=3)
    ms6_once = cuda_ms(lambda: sg.schur_cross_matvec(Wp, dense, vinv, xv), reps=21, warm=3)
    p6 = cuda_ms(lambda: sg.schur_cross_matvec_plain(Wp, dense.camp, vinv, xv), reps=3, warm=1)
    dev6 = ""
    if profile:
        # the event pair around one call times the wrapper's host gaps too
        ms_dev, note = launch_device_ms(lambda: cross(xv), 20)
        dev6 = f"; device {ms_dev:.4f} ms per call by torch.profiler ({note})"
    log(f"[BA kernels] {tag}: K6 schur_cross_matvec: relative error {e6:.3e} (tol {tol6:.0e}), max abs "
        f"{abs6:.3e}; kernel {ms6:.4f} ms by CUDA events around one call of the bound system "
        f"({n_dense * 72 / ms6 / 1e6:.1f} GB/s of W; {ms6_once:.4f} ms through the one-shot wrapper, "
        f"which checks the system each time){dev6}; plain {p6:.3f} ms on {smi}")
    assert e6 <= tol6, f"K6 relative error {e6}"
    # necessary work: W and camp of the real observations, the point rows
    # (Vinv in, vy out), x and z; 72 FLOP per observation
    out["schur_cross_matvec"] = {
        "max_abs_err": abs6, "max_rel_err": e6, "ms": ms6, "plain_ms": p6,
        **bound(n_dense * (72 + 4) + P * (36 + 12) + C * 48, 72.0 * n_dense, "f32")}

    # K8, the four trial steps of an LM iteration
    nc = 4
    cams = torch.cat([sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"],
                                         prob["t"] + 0.01 * c) for c in range(nc)], 0)
    xs = torch.cat([(prob["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
    # bound to the layout once, as ba_solve binds it
    cost = sg.CostFused(dense, uvw)
    got = cost(cams, xs, delta, nc)
    ref = sg.ba_cost_fused_plain(cams, dense.camp, uvw, xs, delta, nc)
    torch.cuda.synchronize()
    e8 = float(((got - ref).abs() / ref).max())
    abs8 = float((got - ref).abs().max())
    tol8 = KERNELS["ba_cost_fused"][2]
    ms8 = cuda_ms(lambda: cost(cams, xs, delta, nc), reps=21, warm=3)
    b2b8 = cuda_ms_per_call(lambda: cost(cams, xs, delta, nc))
    ms8_once = cuda_ms(lambda: sg.ba_cost_fused(cams, dense, uvw, xs, delta, nc=nc), reps=21, warm=3)
    p8 = cuda_ms(lambda: sg.ba_cost_fused_plain(cams, dense.camp, uvw, xs, delta, nc), reps=3, warm=1)
    # the LM loop's invariants: the same bits from a second call, and a
    # candidate's cost the same from an nc = 1 launch as from its place here
    again = sg.ba_cost_fused(cams, dense, uvw, xs, delta, nc=nc)
    alone = [cost(cams[19 * c:19 * c + 19], xs[3 * c:3 * c + 3], delta, 1) for c in range(nc)]
    same8 = torch.equal(got, again) and all(torch.equal(got[c:c + 1], a) for c, a in enumerate(alone))
    dev8 = ""
    if profile:
        ms_dev, note = launch_device_ms(lambda: cost(cams, xs, delta, nc), 20)
        dev8 = f"; device {ms_dev:.4f} ms per call by torch.profiler ({note})"
    log(f"[BA kernels] {tag}: K8 ba_cost_fused nc={nc} ({sg.cost_slot_groups(tp, P)} slot groups): "
        f"relative error {e8:.3e} (tol {tol8:.0e}), max abs {abs8:.3e} of costs "
        f"{[float(f'{c:.4f}') for c in ref.tolist()]}; kernel {ms8:.4f} ms by CUDA events around "
        f"one call bound to the layout ({ms8_once:.4f} ms through the one-shot wrapper, {b2b8:.4f} "
        f"ms per call over 20 back to back){dev8}; "
        f"plain {p8:.3f} ms; two calls and each candidate alone bit-equal {same8}; on {smi}")
    assert e8 <= tol8, f"K8 relative error {e8}"
    assert same8, "K8: a candidate's cost changed between calls or with nc and its place"
    out["ba_cost_fused"] = {
        "max_abs_err": abs8, "max_rel_err": e8, "ms": ms8, "plain_ms": p8,
        **bound(n_dense * (12 + 4) + nc * (P * 12 + C * 76 + 4), 60.0 * nc * n_dense, "f32")}

    return out


def phase_ba_kernels(dev, smi: str, profile: bool) -> None:
    """K7, K6 and K8 against their plain versions on a random problem of
    BA_SHAPE (camera-local visibility, tracks of ~10 views), their times,
    the LM rate of the dense solve beside the planes path, and the same
    dense solve twice."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.solvers import lm
    from tests.smoke_scenes import ba_problem

    C, P, O, tp = (BA_SHAPE[k] for k in ("C", "P", "O", "tp"))
    cg, iters = BA_SHAPE["cg_iters"], BA_SHAPE["lm_iters"]
    prob = {k: torch.as_tensor(v, device=dev)
            for k, v in ba_problem(C, P, O, seed=0, window=16, perturb=0.03).items()}
    lens = np.bincount(prob["pt_id"].cpu().numpy(), minlength=P)
    assert lens.max() <= tp, f"tracks up to {lens.max()} views do not fit tp={tp}"
    ba_kernel_checks("512 cameras", prob, tp, 4.0 / 500.0, smi, profile)

    # the LM rate of both paths, and the dense solve twice
    def solve(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lm.ba_solve(*prob.values(), iters=iters, cg_iters=cg, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    dkw = dict(tp_cap=tp, dense_cg=True)
    solve(**dkw)                                   # warm
    _build.LAUNCHES.reset()
    d1, wall_d = solve(**dkw)
    counts = dict(_build.LAUNCHES.counts)
    d2, _ = solve(**dkw)
    solve()
    pl, wall_p = solve()
    same = all(torch.equal(a, b) for a, b in zip(d1, d2))
    diff = max(float((a - b).abs().max()) for a, b in zip(d1, d2))
    log(f"[BA solve] {iters} LM iterations x {cg} CG steps, C={C} P={P} O={O}: dense path "
        f"(K6-K8) {iters / wall_d:.2f} LM iterations/s ({wall_d * 1e3:.1f} ms), planes path "
        f"{iters / wall_p:.2f}/s ({wall_p * 1e3:.1f} ms); cost {float(d1[3][0]):.5f} -> "
        f"{float(d1[3][-1]):.5f} (dense), -> {float(pl[3][-1]):.5f} (planes); launches "
        f"{json.dumps(counts)}; on {smi}")
    log(f"[BA solve] the same dense solve twice: bit-identical {same}, largest difference "
        f"{diff:.3e}")
    check_launches("BA solve", counts, {"ba_assemble_fused": 2 * iters,
                                        "schur_cross_matvec": 2 * iters * (cg + 2),
                                        "ba_cost_fused": iters + 1})
    assert float(d1[3][-1]) < 0.5 * float(d1[3][0]), "the dense solve did not converge"
    assert abs(float(d1[3][-1]) - float(pl[3][-1])) <= 0.02 * float(pl[3][-1]), \
        "dense and planes solves end at different costs"
    if profile:
        ms_d, by_name, _table = device_ms_per_run(
            lambda: lm.ba_solve(*prob.values(), iters=iters, cg_iters=cg, **dkw), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"[profile] BA dense solve: device {ms_d:.2f} ms of {wall_d * 1e3:.1f} ms wall (busy "
            f"{ms_d / (wall_d * 1e3):.3f}); " + "; ".join(f"{t:.3f} ms {k[:50]}" for k, t in top)
            + f"; on {smi}")


def phase_build_map(frames, poses, dev, smi: str, profile: bool):
    """The N_BUILD-frame exhaustive build through ``build_map``, then K6-K8
    against their plain versions on the final BA's table (the built scene's
    alive observations at the tp the build chose); returns (scene, feats,
    tt, the similarity to the rendered world, launches, kernel stats)."""
    import io

    import torch

    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import build_map
    from sfmx_torch.kernels import _build
    from sfmx_torch.solvers import umeyama
    from sfmx_torch.utils.logging import LOGGER

    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon, max_components=1))
    n = len(frames)
    buf, old = io.StringIO(), LOGGER._stream
    LOGGER._stream = buf
    try:
        with plain_matcher_calls() as plain:
            torch.cuda.synchronize()
            _build.LAUNCHES.reset()
            t0 = time.perf_counter()
            scene, feats, tt, stats = build_map(
                frames, INTR[None], np.zeros(n, np.int32), cfg, dev,
                generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES.counts)
    finally:
        LOGGER._stream = old
    stages = {r["stage"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    eyes = torch.as_tensor(np.stack([eye for _R, _t, eye in poses]), dtype=torch.float32,
                           device=dev)
    ate, sim = umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)
    ate = float(ate)
    n_reg, n_pts, n_obs = scene.counts()
    log(f"[build_map] {n} frames: stage wall "
        + ", ".join(f"{k} {r['wall_s']:.3f} s" for k, r in stages.items())
        + f"; whole {wall:.3f} s; {n_reg}/{n} registered (gate {n}), {n_pts} points, {n_obs} "
        f"alive observations of {tt.n_tracks} tracks; median reprojection "
        f"{stats['final_med_px']:.4f} px (gate < {REPROJ_GATE_PX}); ATE {ate:.4f} m (gate < "
        f"{ATE_GATE_M}; map scale {float(sim[0]):.4f} m per unit); seed pair {stats['init_pair']} "
        f"at {stats['init_med_px']} px; {stats['n_rounds']} rounds; on {smi}")
    log(f"[build_map] reconstruct phases {json.dumps(stats['phase_s'])}; BA calls by path "
        f"{json.dumps(stats['ba_calls'])}, final {json.dumps(stats['ba_path'])}; "
        f"{stats['ba_total_iters']} LM iterations in {stats['ba_total_s']} s = "
        f"{stats['ba_iters_per_s']} iterations/s; calls [obs, iters, s] "
        f"{json.dumps(stats['ba_call_s'])}; launches {json.dumps(launches)}; plain matcher "
        f"calls {plain}")
    assert "cuda" not in plain, "build_map: the plain matcher ran on the card"
    assert n_reg == n, f"build_map: {n_reg}/{n} cameras registered"
    assert stats["final_med_px"] < REPROJ_GATE_PX, f"build_map: {stats['final_med_px']} px"
    assert np.isfinite(ate) and ate < ATE_GATE_M, f"build_map: ATE {ate} m"
    assert stats["ba_path"]["mode"] == "dense", f"final BA on {stats['ba_path']}"
    k6, k7, k8 = (launches.get(k, 0) for k in
                  ("schur_cross_matvec", "ba_assemble_fused", "ba_cost_fused"))
    assert k6 > 0 and k7 > 0 and k8 > 0, f"build_map: BA kernel launches {launches}"
    assert k6 == (cfg.recon.cg_iters + 2) * k7, f"build_map: K6 {k6} vs K7 {k7}"
    assert k8 == k7 // 2 + stats["ba_calls"]["dense"], f"build_map: K8 {k8} vs K7 {k7}"
    ext = extraction_launches()
    assert all(launches.get(k, 0) == v for k, v in ext.items()), launches
    assert launches.get("match_pairs_fused", 0) == 2, launches
    if profile:
        log(f"[profile] build_map: reconstruct {stages['reconstruct']['wall_s']:.2f} s of "
            f"{wall:.2f} s, of which BA {stats['phase_s']['ba']} s; BA's device share is "
            "profiled on the BA solve phase")
    alive = scene.obs_alive
    prob = dict(intr=scene.intr, k_idx=scene.cam_k, R=scene.cam_R, t=scene.cam_t, X=scene.X,
                cam_id=scene.obs_cam[alive], pt_id=scene.obs_pt[alive], uv=scene.obs_uv[alive],
                w_valid=torch.ones(int(alive.sum()), device=dev))
    kstats = ba_kernel_checks(f"{n}-frame build", prob, stats["ba_path"]["tp"],
                              cfg.recon.huber_px / FOCAL, smi, profile)
    return scene, feats, tt, sim, launches, kstats


def phase_loop(tex, scene, feats, tt, sim, dev) -> None:
    """The built map saved, loaded and served by the port's query side:
    N_LOOP_QUERIES held-out frames (midpoints between build frames)
    localized against it, their centers mapped to the rendered world by the
    build's similarity."""
    import tempfile

    import torch

    from examples import room
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.main import localize_images
    from sfmx_torch.localize.localize import build_localization_map
    from sfmx_torch.mapstore.scene import load_scene_np, save_scene
    from sfmx_torch.solvers import umeyama

    with tempfile.TemporaryDirectory() as tmp:
        save_scene(Path(tmp) / "map", scene, extra={"source": "chip_smoke build_map"})
        cols = {k: np.array(v) for k, v in load_scene_np(Path(tmp) / "map").items()}
    for k, v in scene.to_numpy().items():
        assert np.array_equal(cols[k], v), f"scene store round trip changed {k}"
    lmap = build_localization_map(cols, feats.desc.cpu().numpy(), tt.obs_feat, dev,
                                  kp_mask=feats.kp.mask.cpu().numpy(), n_words=64, seed=0)
    mids = room.walk_poses(N_BAND - 1)[1::2]            # between the first pass's frames
    pick = np.round(np.linspace(0, N_BUILD - 2, N_LOOP_QUERIES)).astype(int)
    qposes = [mids[i] for i in pick]
    frames = render(tex, qposes)
    results = localize_images(frames, INTR, lmap, PipelineConfig(),
                              generator=torch.Generator(device=dev).manual_seed(9))
    centers = torch.as_tensor(np.stack([np.asarray(r["center"]) for r in results]),
                              dtype=torch.float32, device=dev)
    world = umeyama.apply_sim3(*sim, centers).cpu().numpy()
    errs = np.array([np.linalg.norm(w - eye) for w, (_R, _t, eye) in zip(world, qposes)])
    n_conf = sum(r["confidence"] > 0 for r in results)
    log(f"[loop] map saved, loaded and served: {lmap.X.shape[0]} landmarks "
        f"({int(lmap.lm_alive.sum())} alive), {lmap.kf_gdesc.shape[0]} keyframes; "
        f"{N_LOOP_QUERIES} held-out frames: center errors "
        f"{[float(f'{e:.4f}') for e in errs]} m, median {np.median(errs):.4f} m (gate < "
        f"{MEDIAN_GATE_M}); {n_conf}/{N_LOOP_QUERIES} localized (gate >= {N_LOOP_MIN})")
    assert np.isfinite(errs).all(), "loop: non-finite pose"
    assert np.median(errs) < MEDIAN_GATE_M, f"loop: median center error {np.median(errs)} m"
    assert n_conf >= N_LOOP_MIN, f"loop: only {n_conf} queries localized"


def phase_ba_crosscheck(dev) -> None:
    """One 8-camera dense ``ba_solve`` on the card (K6-K8, with overflow
    observations chained in) against the plain path on the CPU: first cost
    rtol 1e-4 (the residual's f32 cancellation), final cost within 2 %, R, t
    and X within 2e-2 of a scene 25 units deep (LM amplifies rounding along
    the free scale gauge)."""
    import torch

    from sfmx_torch.solvers import lm
    from tests.smoke_scenes import ba_problem

    prob = ba_problem(8, 300, 2000, seed=5, window=4, long_tracks=6, perturb=0.03)
    lens = np.bincount(prob["pt_id"], minlength=300)
    kw = dict(iters=8, cg_iters=25, tp_cap=8, dense_cg=True,
              ov_cap=int(np.maximum(lens - 8, 0).sum()))
    card = lm.ba_solve(*(torch.as_tensor(v, device=dev) for v in prob.values()), **kw)
    cpu = lm.ba_solve(*(torch.as_tensor(v) for v in prob.values()), **kw)
    c0, c1 = card[3].cpu(), cpu[3]
    dmax = max(float((a.cpu() - b).abs().max()) for a, b in zip(card[:3], cpu[:3]))
    log(f"[BA crosscheck] 8 cameras, {len(prob['pt_id'])} observations ({kw['ov_cap']} overflow): "
        f"cost {float(c0[0]):.6f} -> {float(c0[-1]):.6f} on the card, {float(c1[0]):.6f} -> "
        f"{float(c1[-1]):.6f} on the CPU; R, t, X max |diff| {dmax:.2e} (gate < 2e-2)")
    assert abs(float(c0[0]) - float(c1[0])) <= 1e-4 * float(c1[0])
    assert abs(float(c0[-1]) - float(c1[-1])) <= 0.02 * float(c1[-1])
    assert float(c0[-1]) < 0.5 * float(c0[0]) and dmax < 2e-2


def phase_tune(dev, smi: str) -> None:
    """The sweeps behind the kernels' constants.  K1: the four segments of
    the default config on a 32-image VGA batch and on its half-size octave,
    for tiles and fused-step limits that fit the block's shared memory.  K2:
    tiles and threads a block on the same two shapes.  K4: the landmark tile
    (64 or 128 rows), the depth of the ring and the number of splits, at the
    serving batch's 32,768 query rows and at the burst tail's 2,048 against
    133,120 landmarks of random unit descriptors, by CUDA events around the
    launch and, for the tail, by torch.profiler (an event pair also times
    the wrapper's host path).  K3: keypoints (warps) per block on both
    octaves of a 32-image VGA batch of random levels, 1,024 and 512
    keypoints an image at the octave's sigmas.  K6: slot groups per point on
    the 512-camera problem and on one of the 96-frame build's size (tp =
    64), call time by CUDA events and device time by torch.profiler; K8 on
    the same two problems (four candidates, as an LM iteration calls it):
    slot groups, with the camera tables staged in shared memory and read
    through the cache; then the host's time per call of K6's wrapper and of
    its parts beside two small PyTorch ops."""
    import torch

    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import describe as dsc
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.kernels import scale_space as ss
    from sfmx_torch.kernels import segsum as sg
    from sfmx_torch.solvers import schur
    from tests.smoke_scenes import ba_problem

    cfg = F.ScaleSpaceConfig()
    segs = F.level_taus(cfg)
    g = torch.Generator().manual_seed(0)
    for shape in ((SERVE_BATCH, H_IMG, W_IMG), (SERVE_BATCH, H_IMG // 2, W_IMG // 2)):
        L0 = F.gaussian_blur(torch.rand(shape, generator=g).to(dev), 2.0).contiguous()
        k2 = F.contrast_k2(L0).reshape(-1).contiguous()
        rows = []
        for tile in ((96, 128), (80, 160), (120, 128), (96, 160), (64, 128), (60, 160), (48, 128),
                     (96, 96), (64, 64)):
            for mf in range(1, 9):
                longest = max(len(c) for t in segs for c in ss.fused_chunks(t, mf))
                if ss._plane_bytes(longest, *tile) > ss.SMEM_BYTES:
                    continue

                def run(tile=tile, mf=mf):
                    L = L0
                    for taus in segs:
                        for chunk in ss.fused_chunks(taus, mf):
                            L = ss._diffuse_fused(L, k2, chunk, *tile)

                n = sum(len(ss.fused_chunks(t, mf)) for t in segs)
                rows.append((cuda_ms(run, reps=5, warm=1), tile, mf, n))
        rows.sort()
        log(f"[tune] K1 B={shape[0]} {shape[1]}x{shape[2]}, all 4 segments, ms by (tile, most "
            f"fused steps, launches), best first: "
            + "; ".join(f"{ms:.3f} {t[0]}x{t[1]} {mf} {n}" for ms, t, mf, n in rows) + f"; on {smi}")

    for shape in ((SERVE_BATCH, H_IMG, W_IMG), (SERVE_BATCH, H_IMG // 2, W_IMG // 2)):
        levels = torch.rand((shape[0], cfg.n_levels, *shape[1:]), generator=g).to(dev)
        rows = []
        for tile in ((48, 128), (32, 128), (64, 128), (40, 128), (56, 128), (24, 128), (48, 96),
                     (48, 160), (32, 64), (96, 128)):
            if ss._response_bytes(max(cfg.sigma_levels), *tile) > ss.SMEM_BYTES:
                continue
            for threads in (128, 256, 512, 1024):
                ms = cuda_ms(lambda: ss._response_fused(levels, cfg.sigma_levels, *tile, threads),
                             reps=5, warm=1)
                rows.append((ms, tile, threads))
        rows.sort()
        log(f"[tune] K2 B={shape[0]} {shape[1]}x{shape[2]}, {cfg.n_levels} levels, ms by (tile, "
            f"threads), best first: "
            + "; ".join(f"{ms:.3f} {t[0]}x{t[1]} {th}" for ms, t, th in rows) + f"; on {smi}")

    for shape, K in (((SERVE_BATCH, H_IMG, W_IMG), 1024), ((SERVE_BATCH, H_IMG // 2, W_IMG // 2), 512)):
        B, H, W = shape
        levels = torch.rand((B, cfg.n_levels, H, W), generator=g).to(dev)
        lvl = torch.randint(0, cfg.n_levels, (B, K), generator=g)
        uv = (torch.rand((B, K, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])).to(dev)
        sigma = torch.as_tensor(cfg.sigmas)[lvl].to(dev)
        mask = torch.ones((B, K), dtype=torch.bool, device=dev)
        args = (levels, uv, lvl.to(dev), sigma, mask)
        rows = []
        for kpb in (1, 2, 4, 6, 8, 12, 16):
            ms = cuda_ms_per_call(lambda: dsc.describe_upright(*args, keypoints_per_block=kpb))
            ms_dev = device_ms_per_run(lambda: dsc.describe_upright(*args, keypoints_per_block=kpb),
                                       5)[0]
            rows.append((ms, ms_dev, kpb))
        rows.sort()
        log(f"[tune] K3 B={B} {H}x{W} K={K}, ms per call by CUDA events around 20 calls back to "
            f"back (device ms by torch.profiler) by keypoints per block, best first: "
            + "; ".join(f"{ms:.4f} ({md:.4f}) {kpb}" for ms, md, kpb in rows) + f"; on {smi}")

    def unit_bf16(n):
        x = torch.randn((n, 128), generator=g)
        return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dev).bfloat16().contiguous()

    Kb = 133120
    pool = unit_bf16(Kb)
    for Ka, split_set in ((SERVE_BATCH * 1024, (1, 2)), (N_TAIL * 1024, (1, 2, 4, 8, 12, 16, 24, 32, 64))):
        q = unit_bf16(Ka)
        rows = []
        for tile_rows in (64, 128):
            for stages in (2, 3, 4, 5, 6, 8):
                if stages * tile_rows * 256 + 1024 > ss.SMEM_BYTES:
                    continue
                for splits in split_set:
                    def run(tile_rows=tile_rows, stages=stages, splits=splits):
                        mt._match_top2_cuda(q, pool, splits, tile_rows, stages)

                    ms = cuda_ms(run, reps=5, warm=1)
                    ms_dev = device_ms_per_run(run, 5)[0] if Ka < 4096 else float("nan")
                    rows.append((ms, ms_dev, tile_rows, stages, splits))
        rows.sort()
        flop = 2.0 * Ka * Kb * 128
        log(f"[tune] K4 {Ka} x {Kb} x 128 bf16 ({flop / rows[0][0] / 1e9:.1f} TFLOP/s at the best), "
            f"ms by CUDA events (device ms by torch.profiler) for (tile rows, stages, splits), "
            f"best first: " + "; ".join(f"{ms:.3f} ({md:.3f}) {t} {st} {sp}"
                                        for ms, md, t, st, sp in rows) + f"; on {smi}")

    for tag, (C, P, O, tp, window, longs) in {"512 cameras": (512, 20000, 200000, 32, 16, 0),
                                              "build-sized": (96, 2267, 36000, 64, 24, 100)}.items():
        prob = {k: torch.as_tensor(v, device=dev) for k, v in
                ba_problem(C, P, O, seed=0, window=window, perturb=0.03, long_tracks=longs).items()}
        dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
        uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
        cam19 = sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"], prob["t"])
        _U, _bc, v13, Wp = sg.ba_assemble_fused(cam19, dense, uvw, prob["X"].T.contiguous(), 0.008)
        cross = sg.SchurMatvec(Wp, dense, schur._damp_inv3_rows(v13[:9], 1e-4).contiguous())
        xv = torch.randn((6, C), generator=g).to(dev)
        parts = []
        for groups in (1, 2, 4, 8, 16, 32):
            ms = cuda_ms(lambda: cross(xv, groups=groups), reps=21, warm=3)
            ms_dev, by_name, _t = device_ms_per_run(lambda: cross(xv, groups=groups), 20)
            parts.append(f"{groups}: {ms:.4f} call, {ms_dev:.4f} device ("
                         + " + ".join(f"{t:.4f}" for t in by_name.values()) + ")")
        log(f"[tune] K6 {tag} C={C} P={P} O={int(dense.cnt.sum())} tp={tp} (longest track "
            f"{int(dense.cnt.max())}), ms by slot groups: " + "; ".join(parts) + f"; on {smi}")
        nc = 4
        cams = torch.cat([sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"],
                                             prob["t"] + 0.01 * c) for c in range(nc)], 0)
        xs = torch.cat([(prob["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()
        cost8 = sg.CostFused(dense, uvw)
        rows = []
        for groups in (1, 2, 4, 8, 16):
            for stage in (True, False):
                def k8(groups=groups, stage=stage):
                    cost8(cams, xs, 0.008, nc, groups=groups, stage=stage)

                rows.append((device_ms_per_run(k8, 20)[0], cuda_ms(k8, reps=21, warm=3), groups, stage))
        rows.sort()
        log(f"[tune] K8 {tag} nc={nc} (camera tables {19 * nc * C * 4 / 1024:.1f} KB), device ms by "
            f"torch.profiler [call ms by CUDA events] by (slot groups, "
            f"tables staged), best first: "
            + "; ".join(f"{md:.4f} [{ms:.4f}] {gr} {st}" for md, ms, gr, st in rows) + f"; on {smi}")

    # where a call's host time goes (the last system above): the CUDA-event
    # time of one K6 call is the host's path to its second launch
    def host_us(fn, n: int = 2000) -> float:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    a, b = torch.randn((C, 6), generator=g).to(dev), torch.randn((C, 6), generator=g).to(dev)
    f32 = torch.float32
    probes = {
        "bound K6 call": lambda: cross(xv),
        "one-shot K6 wrapper": lambda: sg.schur_cross_matvec(Wp, dense, cross.Vinv9, xv),
        "one-shot K8 wrapper, nc=4": lambda: sg.ba_cost_fused(cams, dense, uvw, xs, 0.008, nc=nc),
        "bound K8 call, nc=4": lambda: cost8(cams, xs, 0.008, nc),
        "two torch.empty": lambda: (torch.empty((3, P), dtype=f32, device=dev),
                                    torch.empty((6, C), dtype=f32, device=dev)),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_build.stream_ptr": lambda: _build.stream_ptr(dev),
        "a + b on (C,6)": lambda: a + b,
        "torch.sum(a * b)": lambda: torch.sum(a * b),
    }
    log("[tune] host us per call, back to back without a sync: "
        + "; ".join(f"{k} {host_us(fn):.2f}" for k, fn in probes.items()) + f"; on {smi}")


def main() -> int:
    import torch

    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import sfmx_torch  # noqa: F401  (sets the TF32 flags)
    from examples import room
    from tests import smoke_scenes

    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    phase_build()
    if "--tune" in sys.argv[1:]:
        phase_tune(dev, smi)
        return 0
    tex = room.RoomTexture(seed=0)
    probe = render(tex, query_poses())
    phase_kernels(probe, dev)
    lmap, kf = phase_map(tex, dev)
    frames, launches = phase_queries(tex, lmap, dev)
    phase_crosscheck(frames, lmap, dev)
    phase_tripwire(dev)
    extract, localize = query_path(frames, lmap, dev)
    wall = phase_rate(extract, localize, len(frames), smi)
    if profile:
        phase_profile({"extraction": extract, "localization": localize}, wall, smi,
                      "query", len(frames))
    phase_tracking(frames, lmap, dev)

    big = phase_map_scale(kf, dev)
    t0 = time.perf_counter()
    serve_frames = smoke_scenes.render_parallel(0, serve_poses(), W_IMG, H_IMG, FOCAL,
                                                RENDER_WORKERS)
    own_frames = smoke_scenes.render_parallel(0, serve_poses()[:2], W_IMG, H_IMG, FOCAL_OWN,
                                              RENDER_WORKERS)
    log(f"[serve] {len(serve_frames) + len(own_frames)} held-out frames rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    # K1-K3 again at the serving run's batch shapes: a full batch of 32 (its
    # errors and times go into the kernels line beside the serving-run
    # launches) and the tail batch of the two own-intrinsics requests
    kstats = phase_kernels(serve_frames[:SERVE_BATCH], dev, profile)
    phase_kernels(own_frames, dev, profile)
    kstats["match_top2"] = phase_k4(big, serve_frames, dev, smi, profile)
    serve_launches = phase_serve(big, serve_frames, own_frames, dev, smi)
    s_extract, s_localize, s_state = streaming_path(serve_frames, big, dev)
    phase_streaming_crosscheck(big, s_state, dev)
    s_wall = phase_rate(s_extract, s_localize, SERVE_BATCH, smi, label="streaming path")
    if profile:
        phase_profile({"extraction": s_extract, "streaming localization": s_localize},
                      s_wall, smi, "streaming", SERVE_BATCH)

    front_stats, front_launches, build_frames, build_poses = phase_front_end(dev, smi, profile)
    kstats.update(front_stats)

    phase_ba_kernels(dev, smi, profile)
    scene, b_feats, b_tt, sim, map_launches, ba_stats = phase_build_map(
        build_frames, build_poses, dev, smi, profile)
    kstats.update(ba_stats)
    phase_loop(tex, scene, b_feats, b_tt, sim, dev)
    phase_ba_crosscheck(dev)

    check_launches("gather path", launches, extraction_launches())
    log(f"[counters] serving-run launches {json.dumps(serve_launches)}")
    for k in SERVE_KERNELS:
        assert serve_launches.get(k, 0) > 0, f"{k} was not launched in the serving run"
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")

    log(f"[counters] build_map launches {json.dumps(map_launches)}")
    path_launches = {**{k: serve_launches[k] for k in SERVE_KERNELS}, **front_launches,
                     **{k: map_launches[k] for k in ("schur_cross_matvec", "ba_assemble_fused",
                                                     "ba_cost_fused")}}
    kernels = [{"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
                "launches": path_launches[k], **kstats[k]} for k in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
