"""The port's ``sfmx bench`` (port of ``bench.py``): the system's metrics,
each by bench.py's name and unit, behind the same correctness gate.

One function per function of bench.py, under its name, with its inputs
(the same numpy draws in the same order from the same seeds), its
repetition counts and its formulas; each calls the port's counterpart of
the reference's entry point on ``device``.  Each takes keyword sizes whose
defaults are bench.py's; nothing but a caller in Python sets them (the
CPU tests shrink them).  Random draws where the reference draws from
``jax.random.PRNGKey(s)`` come from a ``torch.Generator`` on the device
seeded with ``s``, so they are not the reference's.

Timings end in ``torch.cuda.synchronize()``, where bench.py fences with a
host read of one element.  ``main`` catches nothing and retries nothing: a
failure anywhere raises.  It prints, on one line, each function's kernel
launches (``_build.LAUNCHES`` counted from 0 for that function) and, on a
card, the utilization shares against the card's published peaks beside the
measured ones; then, as its last line, bench.py's JSON line (values
unrounded) with one key more, ``device``: the card's name, its power limit
and the device count.

    python -m sfmx_torch.bench [--device cuda|cpu]
    python -m sfmx_torch.cli.main bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import time

import numpy as np
import torch

from .kernels import _build
from .localize.localize import LocalizationMap

B = 16          # query batch
H, W = 480, 640
K_FEAT = 512
P_MAP = 8192    # landmarks
C_KF = 256      # keyframes
FOCAL = 560.0

BA_BYTES_PER_OBS = 252.0   # bench.py's BA traffic model, per observation per CG step
PUBLISHED_BF16_TFLOPS = 989.0   # one H100 SXM, dense bf16 on the tensor cores
PUBLISHED_HBM_GBPS = 3350.0     # its HBM3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _intr(device: torch.device) -> torch.Tensor:
    return torch.tensor([FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0], dtype=torch.float32,
                        device=device)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def pair_flops(K: int, D: int) -> float:
    """bench.py's FLOP model of one matched pair: one (K,D)x(D,K) GEMM."""
    return 2.0 * K * K * D


def ba_bytes_per_lm_iter(cg_iters: int, O: int) -> float:
    """bench.py's traffic model of one LM iteration: 252 B per observation
    per CG step."""
    return cg_iters * O * BA_BYTES_PER_OBS


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def example_map(P: int, C: int, D: int, Kc: int, seed: int, device) -> LocalizationMap:
    """A random unit-descriptor map, drawn as ``__graft_entry__._example_map``
    draws it (lm_desc, kf_gdesc, kf_lm, X, kf_centers, in that order), so one
    seed gives both packages the same arrays."""
    rng = np.random.default_rng(seed)
    lm_desc = rng.standard_normal((P, D)).astype(np.float32)
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    kf_g = rng.standard_normal((C, D)).astype(np.float32)
    kf_g /= np.linalg.norm(kf_g, axis=1, keepdims=True)
    kf_lm = rng.integers(0, P, size=(C, Kc)).astype(np.int32)
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    kf_centers = rng.uniform(-2, 2, (C, 3)).astype(np.float32)
    return LocalizationMap.from_numpy(dict(
        X=X, lm_desc=lm_desc, lm_alive=np.ones(P, bool), kf_gdesc=kf_g,
        kf_alive=np.ones(C, bool), kf_centers=kf_centers, kf_lm=kf_lm,
        kf_lm_mask=np.ones((C, Kc), bool)), device)


def tripwire_case(seed: int = 42, P: int = 8192, C: int = 64, Kc: int = 128,
                  D: int = 128, K: int = 512):
    """bench.py's tripwire: a random map of P landmarks in front of an
    identity camera and K exact projections of landmarks of 4 keyframes.
    A correct gather path recovers R = I, t = 0 with >= K/2 inliers.
    Returns (map columns, q_desc (K,D), q_uv (K,2), intr (7,))."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3.0, 8.0, P)
    lm_desc = rng.standard_normal((P, D)).astype(np.float32)
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    kf_lm = rng.permutation(P)[: C * Kc].reshape(C, Kc).astype(np.int32)
    kf_g = lm_desc[kf_lm].mean(1)
    kf_g /= np.maximum(np.linalg.norm(kf_g, axis=1, keepdims=True), 1e-8)
    cols = dict(X=X, lm_desc=lm_desc, lm_alive=np.ones(P, bool), kf_gdesc=kf_g,
                kf_alive=np.ones(C, bool), kf_centers=np.zeros((C, 3), np.float32),
                kf_lm=kf_lm, kf_lm_mask=np.ones((C, Kc), bool))
    sel = kf_lm[:4].reshape(-1)[:K]
    q_uv = np.stack([FOCAL * X[sel, 0] / X[sel, 2] + W / 2,
                     FOCAL * X[sel, 1] / X[sel, 2] + H / 2], 1).astype(np.float32)
    intr = np.array([FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0], np.float32)
    return cols, lm_desc[sel], q_uv, intr


def random_queries(rng: np.random.Generator, n: int, K: int, device):
    """n queries of K unit descriptors at uniform pixels of a VGA frame
    (bench.py's feature-level queries): (q_desc, q_uv, q_mask) on device."""
    q_desc = rng.standard_normal((n, K, 128)).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    q_uv = rng.uniform(0, W, (n, K, 2)).astype(np.float32)
    return (torch.from_numpy(q_desc).to(device), torch.from_numpy(q_uv).to(device),
            torch.ones((n, K), dtype=torch.bool, device=device))


def matching_inputs(device, *, C: int = 64, K: int = K_FEAT, npairs: int = 512):
    """``matching_throughput``'s descriptors (C,K,128), masks and pairs."""
    rng = np.random.default_rng(0)
    descs = rng.standard_normal((C, K, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    pairs = rng.integers(0, C, (npairs, 2)).astype(np.int32)
    return (torch.from_numpy(descs).to(device), torch.ones((C, K), dtype=torch.bool,
                                                            device=device),
            torch.from_numpy(pairs).to(device))


def streaming_inputs(device, *, B: int = B, K: int = K_FEAT, P: int = 100_352, C: int = 512):
    """``streaming_localize_fps``'s map and queries: (lmap, q_desc, q_uv, q_mask)."""
    lmap = example_map(P, C, 128, 256, 0, device)
    return (lmap, *random_queries(np.random.default_rng(1), B, K, device))


# ---------------------------------------------------------------------------
# The benchmarks
# ---------------------------------------------------------------------------


def measure_peaks(device, *, n: int = 4096, chain: int = 32, m: int = 64 * 1024 * 1024,
                  reps: int = 3):
    """Measured ceilings the utilization shares divide by: bf16 matmul
    FLOP/s of a chain of n^3 GEMMs (f32 accumulation, a bf16 result scaled
    by 1/n, as bench.py's) and memory bytes/s of a chain of f32 adds over
    256 MiB (each read and written).  A library GEMM is right here: this is
    a yardstick, not a kernel of the system."""
    device = torch.device(device)
    a = torch.ones((n, n), dtype=torch.bfloat16, device=device)

    def gemm_chain(a):
        x = a
        for _ in range(chain):
            x = torch.matmul(x, a) * (1.0 / n)
        return x

    gemm_chain(a)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        gemm_chain(a)
    _sync(device)
    tflops = 2.0 * n ** 3 * chain * reps / (time.perf_counter() - t0) / 1e12

    def add_chain(x):
        for _ in range(chain):
            x = x + 1.0
        return x

    x = torch.ones(m, dtype=torch.float32, device=device)
    add_chain(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        add_chain(x)
    _sync(device)
    gbps = 2.0 * 4.0 * m * chain * reps / (time.perf_counter() - t0) / 1e9
    return tflops, gbps


def matching_throughput(peak_tflops: float, device, *, C: int = 64, K: int = K_FEAT,
                        npairs: int = 512, reps: int = 40):
    """Pairwise matching of 512 random pairs through the production entry
    ``match_pairs_float_auto`` (K5 on a card), 40 calls back to back:
    (pairs/s, MFU = pairs/s x 2K^2D / peak)."""
    from .kernels import matching

    device = torch.device(device)
    descs, masks, pairs = matching_inputs(device, C=C, K=K, npairs=npairs)
    matching.match_pairs_float_auto(descs, masks, pairs)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        matching.match_pairs_float_auto(descs, masks, pairs)
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    pairs_per_s = npairs / dt
    return pairs_per_s, pairs_per_s * pair_flops(K, descs.shape[-1]) / (peak_tflops * 1e12)


def matching_throughput_band(peak_tflops: float, device, *, C: int = 256, K: int = K_FEAT,
                             reps: int = 10):
    """The same entry on a map build's pair distribution over 256 images:
    every pair within 26 frames plus 1,536 random draws across the halves."""
    from .kernels import matching

    device = torch.device(device)
    rng = np.random.default_rng(0)
    descs = rng.standard_normal((C, K, 128)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    masks = torch.ones((C, K), dtype=torch.bool, device=device)
    pairs = {(a, b) for a in range(C) for b in range(a + 1, min(a + 27, C))}
    pairs |= {(int(rng.integers(0, C // 2)), int(rng.integers(C // 2, C)))
              for _ in range(C * 6)}
    pairs = torch.from_numpy(np.array(sorted(pairs), np.int32)).to(device)
    descs = torch.from_numpy(descs).to(device)
    matching.match_pairs_float_auto(descs, masks, pairs)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        matching.match_pairs_float_auto(descs, masks, pairs)
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    pairs_per_s = len(pairs) / dt
    return pairs_per_s, pairs_per_s * pair_flops(K, descs.shape[-1]) / (peak_tflops * 1e12)


def ba_throughput(hbm_gbps: float, device, *, C: int = 512, P: int = 20000, O: int = 200000,
                  iters: int = 10, cg_iters: int = 30):
    """Global BA at 512 cameras / 20,000 points / 200,000 observations with
    camera-local visibility: ``lm.ba_solve(dense_cg=True, tp_cap=tp)``, 10 LM
    iterations x 30 CG steps (K6-K8 on a card), one warm solve, one timed.
    The reference's ``cam_window`` is a TPU fence the port has no use for.
    Returns (LM iterations/s, bench.py's roofline fraction: 252 B per
    observation per CG step over the measured memory rate)."""
    from .solvers import lm

    device = torch.device(device)
    rng = np.random.default_rng(0)
    X = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    t = np.concatenate([rng.uniform(-5, 5, (C, 2)),
                        np.full((C, 1), 20.0)], 1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    pt_id = np.sort(rng.integers(0, P, O).astype(np.int32))
    span = 24
    base = (pt_id.astype(np.float64) / P * (C - span)).astype(np.int32)
    cam_id = (base + rng.integers(0, span, O)).astype(np.int32)
    tp = 1 << max(3, (int(np.bincount(pt_id).max()) - 1).bit_length())
    Xc = X[pt_id] + t[cam_id]
    uv = ((Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.asarray([320.0, 240.0])
          + 0.5 * rng.standard_normal((O, 2))).astype(np.float32)
    intr = np.asarray([[500.0, 500.0, 320.0, 240.0, 0, 0, 0]], np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    args = (T(intr), torch.zeros(C, dtype=torch.int32, device=device), T(R), T(t), T(X),
            T(cam_id), T(pt_id), T(uv), torch.ones(O, dtype=torch.float32, device=device),
            T(fixed))
    kw = dict(iters=iters, cg_iters=cg_iters, tp_cap=tp, dense_cg=True)
    lm.ba_solve(*args, **kw)
    _sync(device)
    t0 = time.perf_counter()
    lm.ba_solve(*args, **kw)
    _sync(device)
    lm_iters_per_s = iters / (time.perf_counter() - t0)
    return lm_iters_per_s, lm_iters_per_s * ba_bytes_per_lm_iter(cg_iters, O) / (hbm_gbps * 1e9)


def streaming_localize_fps(device, *, B: int = B, K: int = K_FEAT, P: int = 100_352,
                           C: int = 512, reps: int = 5):
    """A 16-query batch against every landmark of a 100,352-landmark map in
    one K4 call (``localize_batch_streaming``, 512 hypotheses), 5 batches,
    each with a generator seeded anew (1..5): frames/s."""
    from .localize import localize

    device = torch.device(device)
    lmap, q_desc, q_uv, q_mask = streaming_inputs(device, B=B, K=K, P=P, C=C)
    intr = _intr(device)

    def fn(seed):
        return localize.localize_batch_streaming(lmap, q_desc, q_uv, q_mask, intr,
                                                 generator=_gen(device, seed),
                                                 k_hypotheses=512)

    fn(0)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i + 1)
    _sync(device)
    return B * reps / (time.perf_counter() - t0)


def tracking_fps(device, *, N: int = 64, K: int = K_FEAT, P: int = P_MAP, C: int = C_KF):
    """Sequential tracking of a 64-frame feature sequence
    (``tracking.localize_sequence``, radius 1e6, min_conf 0, so every frame
    after the first takes the prior-gated branch): frames/s.  The
    reference runs the sequence as one ``lax.scan`` program
    (``_sequence_scan``); the port's counterpart is its per-frame loop,
    which reads each frame's confidence on the host."""
    from .localize import tracking

    device = torch.device(device)
    lmap = example_map(P, C, 128, 256, 0, device)
    q_desc, q_uv, q_mask = random_queries(np.random.default_rng(2), N, K, device)
    intr = _intr(device)
    cfg = tracking.TrackingConfig(radius=1e6, min_conf=0.0, min_inliers=0,
                                  k_hypotheses=512, m_cap=2048)
    tracking.localize_sequence(lmap, q_desc, q_uv, q_mask, intr, cfg,
                               generator=_gen(device, 0))
    _sync(device)
    t0 = time.perf_counter()
    tracking.localize_sequence(lmap, q_desc, q_uv, q_mask, intr, cfg,
                               generator=_gen(device, 1))
    _sync(device)
    return N / (time.perf_counter() - t0)


def tpu_frames_per_s(device, *, B: int = B, H: int = H, W: int = W, P: int = P_MAP,
                     C: int = C_KF, K: int = K_FEAT, reps: int = 5):
    """The headline: a B=16 VGA batch through extraction
    (``detect_and_describe``, 512 keypoints, threshold 1e-7: K1-K3 on a
    card) and ``localize_batch`` (top 8 keyframes, m_cap 2048, 512
    hypotheses) against a device-resident 8,192-landmark map.  Returns
    (frames/s over 5 batches, compile_s: the first batch's wall, the
    kernels' build and load included)."""
    from .kernels import features
    from .localize import localize

    device = torch.device(device)
    lmap = example_map(P, C, 128, 256, 0, device)
    intr = torch.tensor([FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0], dtype=torch.float32,
                        device=device)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((B, H, W)).astype(np.float32)).to(device)

    def query_path(seed):
        f = features.detect_and_describe(imgs, max_keypoints=K, threshold=1e-7)
        return localize.localize_batch(lmap, f.desc, f.kp.uv, f.kp.mask, intr,
                                       generator=_gen(device, seed), top_k_kf=8,
                                       m_cap=2048, k_hypotheses=512)

    t0 = time.perf_counter()
    query_path(0)
    _sync(device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(reps):
        query_path(i + 1)
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    return B / dt, compile_s


def accuracy_tripwire(device, *, P: int = 8192, C: int = 64, Kc: int = 128, K: int = K_FEAT):
    """The gate before any timing: a query whose descriptors are landmark
    descriptors and whose pixels are their exact projections at R = I,
    t = 0 must localize through both production paths (gather
    ``localize_query`` and streaming), with bench.py's bounds."""
    from .localize import localize

    device = torch.device(device)
    cols, q_desc, q_uv, intr = tripwire_case(P=P, C=C, Kc=Kc, K=K)
    lmap = LocalizationMap.from_numpy(cols, device)
    q_desc, q_uv, intr = (torch.from_numpy(a).to(device) for a in (q_desc, q_uv, intr))
    q_mask = torch.ones(K, dtype=torch.bool, device=device)

    res = localize.localize_query(lmap, q_desc, q_uv, q_mask, intr, generator=_gen(device, 7),
                                  top_k_kf=8, m_cap=2048, k_hypotheses=512)
    n_inl = int(res.n_inliers)
    conf = float(res.confidence)
    terr = float(torch.linalg.vector_norm(res.t))
    rerr = float(torch.linalg.matrix_norm(res.R - torch.eye(3, device=device)))
    _check(n_inl >= K // 2, f"tripwire: gather path inliers {n_inl} < {K // 2}")
    _check(conf > 0.5, f"tripwire: gather path confidence {conf}")
    _check(terr < 0.05, f"tripwire: gather path |t| {terr}")
    _check(rerr < 0.02, f"tripwire: gather path |R-I| {rerr}")

    sres = localize.localize_batch_streaming(lmap, q_desc[None], q_uv[None], q_mask[None],
                                             intr, generator=_gen(device, 7),
                                             k_hypotheses=512)
    n_inl = int(sres.n_inliers[0])
    terr = float(torch.linalg.vector_norm(sres.t[0]))
    _check(n_inl >= K // 2, f"tripwire: streaming inliers {n_inl}")
    _check(terr < 0.05, f"tripwire: streaming |t| {terr}")


def cpu_baseline_frames_per_s():
    """bench.py's stand-in for the reference stack, on this host's CPU:
    OpenCV SIFT + brute-force ratio matching + ``solvePnPRansac``, frames/s.
    None without ``cv2``, as in bench.py, and ``vs_baseline`` is then null;
    with it, ``vs_baseline`` divides the card's rate by this host's."""
    try:
        import cv2
    except ImportError:
        return None
    rng = np.random.default_rng(0)
    img = (rng.random((H, W)) * 255).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    sift = cv2.SIFT_create(nfeatures=K_FEAT)
    map_desc = rng.random((2048, 128)).astype(np.float32)
    bf = cv2.BFMatcher(cv2.NORM_L2)
    obj = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    imgp = rng.uniform(0, 640, (512, 2)).astype(np.float32)
    Kmat = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        _kp, desc = sift.detectAndCompute(img, None)
        if desc is not None and len(desc) >= 2:
            bf.knnMatch(desc[:K_FEAT], map_desc, k=2)
        cv2.solvePnPRansac(obj, imgp, Kmat, None, iterationsCount=512,
                           reprojectionError=4.0)
    return reps / (time.perf_counter() - t0)


def geometric_verify_pairs_per_s(device, *, Np: int = 256, K: int = K_FEAT, H: int = 256,
                                 reps: int = 5):
    """Batched E-RANSAC verification of 256 pairs x 512 matches x 256
    hypotheses through ``matching.geometric_verify_pairs``: pairs/s.  Each
    call's Gumbel noise (``ransac.gumbel_noise``, seeds 0, 0..4) is drawn
    before the timed window."""
    from .kernels import matching
    from .solvers.ransac import gumbel_noise

    device = torch.device(device)
    rng = np.random.default_rng(3)
    xn = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, K, 2)).astype(np.float32)).to(device)
    kp_mask = torch.ones((8, K), dtype=torch.bool, device=device)
    pairs = torch.from_numpy(rng.integers(0, 8, (Np, 2)).astype(np.int32)).to(device)
    matches = matching.MatchResult(
        idx=torch.from_numpy(rng.integers(0, K, (Np, K))).to(device),
        valid=torch.ones((Np, K), dtype=torch.bool, device=device),
        score=torch.ones((Np, K), dtype=torch.float32, device=device))

    def noise(seed):
        return gumbel_noise((Np, H, K), device=device, generator=_gen(device, seed))

    def fn(g):
        return matching.geometric_verify_pairs(g, xn, kp_mask, pairs, matches, threshold=1e-5)

    fn(noise(0))
    _sync(device)
    gs = [noise(i) for i in range(reps)]
    _sync(device)
    t0 = time.perf_counter()
    for g in gs:
        fn(g)
    _sync(device)
    return Np * reps / (time.perf_counter() - t0)


def extract_stream_fps(device, *, B: int = 16, H: int = 240, W: int = 320, K: int = K_FEAT,
                       reps: int = 8):
    """Warm extraction throughput: a host batch of 16 QVGA frames through
    ``pipeline._extract_raw`` (its copy to the device included), 8 times:
    frames/s."""
    from .cli import pipeline
    from .cli.config import FeatureConfig, PipelineConfig

    device = torch.device(device)
    cfg = PipelineConfig(features=FeatureConfig(max_keypoints=K))
    rng = np.random.default_rng(0)
    imgs = rng.random((B, H, W)).astype(np.float32)
    pipeline._extract_raw(imgs, cfg, device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        pipeline._extract_raw(imgs, cfg, device)
    _sync(device)
    return B * reps / (time.perf_counter() - t0)


def serving_p95_ms(device, *, P: int = 20000, C: int = 128, B: int = B, K: int = K_FEAT):
    """Serving latency: 6 bursts of 16 concurrent feature-level requests
    through ``LocalizationService`` (5 ms window, batches of up to 16) on a
    20,000-landmark map; the first 3 bursts' latencies are dropped.
    Returns the p95 latency in ms."""
    from .cli.config import PipelineConfig
    from .serve.server import LocalizationService, ServiceStats

    device = torch.device(device)
    lmap = example_map(P, C, 128, 256, 0, device)
    svc = LocalizationService(batch_window_ms=5.0, max_batch=16)
    svc.load_map("m", lmap, np.asarray([FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0], np.float32),
                 cfg=PipelineConfig())
    rng = np.random.default_rng(5)
    q_desc = rng.standard_normal((B, K, 128)).astype(np.float32)
    q_desc /= np.linalg.norm(q_desc, axis=-1, keepdims=True)
    q_uv = rng.uniform(0, W, (B, K, 2)).astype(np.float32)
    q_mask = np.ones((B, K), bool)

    async def run():
        await svc.start()
        try:
            for r in range(6):
                if r == 3:
                    svc.stats = ServiceStats()  # drop the warm bursts' latencies
                await asyncio.gather(*[svc.localize("m", q_desc[i], q_uv[i], q_mask[i])
                                       for i in range(B)])
            return svc.stats.snapshot()
        finally:
            await svc.stop()

    return asyncio.run(run())["p95_latency_ms"]


def map_build_fps(device, *, frames: int = 96, width: int = 320, height: int = 240):
    """End-to-end map build of 96 rendered QVGA room frames (``examples.room``)
    through ``pipeline.build_map`` (extract, window pairs, match, verify,
    tracks, incremental SfM, BA): (frames/s, build stats).  The verification
    noise comes from a generator seeded 0, as the reference seeds its
    verification keys.  Raises when fewer than 90 % of the frames register."""
    from examples import room

    from .cli import pipeline
    from .cli.config import FeatureConfig, MatchConfig, PipelineConfig

    device = torch.device(device)
    tex = room.RoomTexture(seed=7)
    poses = room.walk_poses(frames)
    focal = 280.0 * width / 320
    imgs = np.stack([room.render_room(tex, R, eye, width, height, focal)
                     for (R, _t, eye) in poses])
    intr = np.array([[focal, focal, width / 2, height / 2, 0, 0, 0]], np.float32)
    cfg = PipelineConfig(
        features=FeatureConfig(max_keypoints=512),
        match=MatchConfig(pair_mode="window", window=max(6, frames // 8)),
        resize_to=(width, height), focal_factor=0.875)
    t0 = time.perf_counter()
    _scene, _feats, _tt, stats = pipeline.build_map(imgs, intr, np.zeros(frames, np.int32),
                                                    cfg, device, generator=_gen(device, 0))
    _sync(device)
    wall = time.perf_counter() - t0
    if stats["n_registered"] < 0.9 * frames:
        raise RuntimeError(f"map build degraded: {stats['n_registered']}/{frames}")
    return frames / wall, stats


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def device_info(device: torch.device) -> dict:
    """The device the numbers were taken on: a card's name and power limit
    (``nvidia-smi``) and the number of cards; for the CPU its name only."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": 1}
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": smi[index].split(",")[-1].strip(),
            "count": torch.cuda.device_count()}


def main(device="cuda"):
    """Run every benchmark on ``device``, the tripwire first; print the
    launches-and-shares line and then bench.py's JSON line (plus
    ``device``); return (that line's dict, launches per function)."""
    device = torch.device(device)
    torch.empty(0, device=device)        # no card: torch's own error, before any work
    launches: dict[str, dict] = {}

    def counted(fn, *args, **kw):
        _build.LAUNCHES.reset()
        out = fn(*args, **kw)
        _sync(device)
        launches[fn.__name__] = {k: v for k, v in _build.LAUNCHES.counts.items() if v}
        return out

    # the correctness gate first: garbage poses must fail the bench, not pass it
    counted(accuracy_tripwire, device)
    value, compile_s = counted(tpu_frames_per_s, device)
    base = cpu_baseline_frames_per_s()
    tflops, gbps = counted(measure_peaks, device)
    pps, mfu = counted(matching_throughput, tflops, device)
    bpps, bmfu = counted(matching_throughput_band, tflops, device)
    ips, frac = counted(ba_throughput, gbps, device)
    extras = {
        "peak_bf16_tflops": tflops, "hbm_gbps": gbps,
        "matching_pairs_per_s": pps, "matching_mfu": mfu,
        "matching_band_pairs_per_s": bpps, "matching_band_mfu": bmfu,
        "ba_lm_iters_per_s": ips, "ba_hbm_roofline_frac": frac,
        "streaming_localize_fps": counted(streaming_localize_fps, device),
        "tracking_fps": counted(tracking_fps, device),
        "geometric_verify_pairs_per_s": counted(geometric_verify_pairs_per_s, device),
        "extract_fps": counted(extract_stream_fps, device),
        "serving_p95_ms": counted(serving_p95_ms, device),
    }
    build_fps, bstats = counted(map_build_fps, device)
    extras["map_build_fps"] = build_fps
    extras["map_build_ba_path"] = (bstats.get("ba_path") or {}).get("mode")
    info = device_info(device)
    detail = {"launches": launches, "device": info}
    if device.type == "cuda":
        # shares of the card's published peaks beside bench.py's measured ones
        detail["published"] = {
            "bf16_tflops": PUBLISHED_BF16_TFLOPS, "hbm_gbps": PUBLISHED_HBM_GBPS,
            "power_limit": info["power_limit"],
            "peak_bf16_share": tflops / PUBLISHED_BF16_TFLOPS,
            "hbm_share": gbps / PUBLISHED_HBM_GBPS,
            "matching_mfu": mfu * tflops / PUBLISHED_BF16_TFLOPS,
            "matching_band_mfu": bmfu * tflops / PUBLISHED_BF16_TFLOPS,
            "ba_hbm_roofline_frac": frac * gbps / PUBLISHED_HBM_GBPS}
    line = {"metric": "query_localization_throughput", "value": value,
            "unit": "frames/s/chip", "vs_baseline": value / base if base else None,
            "compile_s": compile_s, **extras, "device": info}
    print(json.dumps(detail), flush=True)
    print(json.dumps(line), flush=True)
    return line, launches


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
