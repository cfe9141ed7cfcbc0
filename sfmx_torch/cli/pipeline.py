"""Batch pipeline (port of ``sfmx.cli.pipeline``): extraction dispatch
(the AKAZE analog or SIFT), streaming extraction that decodes chunk i+1 on
host threads while the card extracts chunk i, and the map build — pair
selection, matching, E-RANSAC verification, tracks and incremental
reconstruction with bundle adjustment, the front-end stages behind the
content-addressed stage cache (a killed build re-runs only the stages it
had not finished).
"""
from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

import numpy as np
import torch

from ..core.masking import NEG_INF
from ..kernels import features
from ..kernels.matching import MatchResult
from ..utils.logging import LOGGER
from .config import PipelineConfig


def _extract_raw(images, cfg: PipelineConfig, device) -> features.Features:
    """Extractor dispatch without any host sync: (N,H,W) images in [0,1],
    a numpy array or a tensor."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    images = images.to(device=device, dtype=torch.float32)
    if cfg.features.extractor == "sift":
        from ..kernels import sift

        thr = cfg.features.threshold
        return sift.detect_and_describe_sift(
            images, max_keypoints=cfg.features.max_keypoints,
            # the AKAZE det-Hessian default is meaningless for |DoG|
            threshold=(0.015 if thr < 1e-4 else thr),
            oriented=cfg.features.oriented, n_octaves=cfg.features.n_octaves)
    sscfg = features.ScaleSpaceConfig(sigma_levels=tuple(cfg.features.sigma_levels))
    return features.detect_and_describe(
        images, sscfg,
        max_keypoints=cfg.features.max_keypoints,
        threshold=cfg.features.threshold,
        oriented=cfg.features.oriented,
        n_octaves=cfg.features.n_octaves,
    )


def extract_features(images, cfg: PipelineConfig, device) -> features.Features:
    """``_extract_raw`` under the reference's ``extract`` record (image
    count, extractor, keypoints kept)."""
    with LOGGER.scope("extract", n_images=len(images),
                      extractor=cfg.features.extractor) as out:
        feats = _extract_raw(images, cfg, device)
        out["keypoints"] = int(feats.kp.mask.sum())
    return feats


def extract_features_streaming(paths, cfg: PipelineConfig, device, *, chunk: int = 16,
                               workers: int = 8, resize_to=(640, 480)):
    """Pipelined decode and extraction: host threads decode chunk i+1
    (``ingest.iter_decoded_chunks``) while the card extracts chunk i.

    Nothing inside the loop waits for the card: each chunk's copy to the
    card leaves from pinned memory, and extraction (``_extract_raw``) reads
    nothing back.  The chunks' features are joined by one ``torch.cat`` at
    the end, which equals eager ``extract_features`` on the same images
    (extraction is per image).  Host memory stays O(chunk).
    Returns ``(feats, orig_sizes (N,2) int32)``.
    """
    import time

    from . import ingest

    device = torch.device(device)
    outs, sizes = [], []
    with LOGGER.scope("extract_stream", chunk=chunk, extractor=cfg.features.extractor) as log:
        t_loop = time.perf_counter()
        for imgs, orig in ingest.iter_decoded_chunks(paths, resize_to=resize_to, chunk=chunk,
                                                     workers=workers):
            batch = torch.from_numpy(imgs)
            if device.type == "cuda":  # an asynchronous copy needs pinned memory
                batch = batch.pin_memory().to(device, non_blocking=True)
            outs.append(_extract_raw(batch, cfg, device))
            sizes.append(orig)
        log["loop_s"] = round(time.perf_counter() - t_loop, 4)
        if not outs:
            raise ValueError("extract_features_streaming: no images decoded "
                             "(empty or unreadable path list)")
        t_cat = time.perf_counter()
        kp = features.Keypoints(*(torch.cat(xs) for xs in zip(*(o.kp for o in outs))))
        feats = features.Features(kp, torch.cat([o.desc for o in outs]),
                                  torch.cat([o.desc_bits for o in outs]))
        log["n_images"] = int(feats.desc.shape[0])
        log["keypoints"] = int(feats.kp.mask.sum())
        # loop_s ~ decode + queued extraction; concat_s ~ the drain + one cat
        log["concat_s"] = round(time.perf_counter() - t_cat, 4)
    return feats, np.concatenate(sizes)


# ---------------------------------------------------------------------------
# Stage cache
# ---------------------------------------------------------------------------


def _stage_key(name: str, *parts) -> str:
    h = hashlib.sha256()
    h.update(name.encode())
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:24]


class StageCache:
    """Content-addressed stage outputs on disk (idempotent pipeline re-runs).
    Cached MatchResults decode onto ``device``, which the caller names."""

    def __init__(self, workdir: str | Path | None, device):
        self.dir = Path(workdir) / "stages" if workdir else None
        self.device = torch.device(device)
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)

    def get_or_run(self, name: str, key: str, fn):
        if self.dir:
            p = self.dir / f"{name}-{key}.pkl"
            if p.exists():
                LOGGER.log(name, cached=True, key=key)
                with open(p, "rb") as f:
                    return _cache_decode(pickle.load(f), self.device)
        out = fn()
        if self.dir:
            with open(p, "wb") as f:
                pickle.dump(_cache_encode(out), f)
        return out


def _map_tensors(x, fn):
    """fn applied to every tensor in x, through tuples and NamedTuples
    (which keep their own types)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [_map_tensors(o, fn) for o in x]
        return tuple(items) if type(x) is tuple else type(x)(*items)
    return x


def _cache_encode(out):
    """Sparse-pack MatchResult stage outputs before pickling: the dense
    (Np,K) idx/valid/score arrays are ~1-3% valid after the ratio test and
    cross-check, so only the accepted entries survive, as a (row, col, idx,
    score) COO encoding.  Other tensors are pickled from the CPU."""
    if isinstance(out, MatchResult):
        valid = out.valid.cpu().numpy()
        r, c = np.nonzero(valid)
        return {"__match_coo__": True, "shape": valid.shape,
                "row": r.astype(np.int32), "col": c.astype(np.int32),
                "idx": out.idx.cpu().numpy()[r, c].astype(np.int32),
                "score": out.score.cpu().numpy()[r, c]}
    # PLAIN tuples only: other NamedTuple stage outputs (Features, ...)
    # must survive as their own types
    if type(out) is tuple:
        return tuple(_cache_encode(o) for o in out)
    return _map_tensors(out, lambda t: t.cpu())


def _cache_decode(out, device):
    if isinstance(out, dict) and out.get("__match_coo__"):
        idx = np.zeros(out["shape"], np.int64)
        valid = np.zeros(out["shape"], bool)
        score = np.full(out["shape"], NEG_INF, np.float32)
        idx[out["row"], out["col"]] = out["idx"]
        valid[out["row"], out["col"]] = True
        score[out["row"], out["col"]] = out["score"]
        return MatchResult(idx=torch.as_tensor(idx, device=device),
                           valid=torch.as_tensor(valid, device=device),
                           score=torch.as_tensor(score, device=device))
    if type(out) is tuple:
        return tuple(_cache_decode(o, device) for o in out)
    return _map_tensors(out, lambda t: t.to(device))


# ---------------------------------------------------------------------------
# Pairs, matching, verification
# ---------------------------------------------------------------------------


def build_pairs(n_images: int, mode: str, window: int) -> np.ndarray:
    if mode == "exhaustive":
        return np.array([(a, b) for a in range(n_images) for b in range(a + 1, n_images)],
                        np.int32).reshape(-1, 2)
    if mode == "window":
        return np.array([(a, b) for a in range(n_images)
                         for b in range(a + 1, min(a + 1 + window, n_images))],
                        np.int32).reshape(-1, 2)
    raise ValueError(f"unknown pair mode {mode}")


def build_pairs_retrieval(feats: features.Features, n_images: int, *, k: int = 8,
                          window: int = 8, first: int | None = None, seed: int = 0,
                          n_words: int = 64) -> np.ndarray:
    """Retrieval-limited pair selection: VLAD global descriptors propose the
    top-k most similar frames per image, unioned with a temporal window.
    O(N·k) pairs instead of O(N²), and loop-closure pairs between revisits
    of the same place are proposed.

    ``first`` is the vocabulary's first seed word, an index into the strided
    descriptor sample (the reference draws it with ``jax.random.choice``
    among the valid rows); None draws it uniformly among them from
    ``torch.Generator().manual_seed(seed)``.
    """
    from ..localize import retrieve

    desc, mask = feats.desc, feats.kp.mask                  # (C,K,D), (C,K)
    flat = desc.reshape(-1, desc.shape[-1])
    fmask = mask.reshape(-1)
    stride = max(1, flat.shape[0] // 32768)                 # bound vocab build cost
    flat, fmask = flat[::stride], fmask[::stride]
    if first is None:
        ok = torch.nonzero(fmask.cpu())[:, 0]
        first = int(ok[torch.randint(len(ok), (1,), generator=torch.Generator().manual_seed(seed))])
    vocab = retrieve.build_vocabulary(flat, fmask, first, n_words=n_words)
    g = retrieve.vlad_encode(desc, mask, vocab)             # (C, V*D)
    S = (g @ g.T).cpu().numpy()
    np.fill_diagonal(S, -np.inf)
    pairs = set()
    kk = min(k, n_images - 1)
    for a in range(n_images):
        for b in range(a + 1, min(a + 1 + window, n_images)):
            pairs.add((a, b))
        for b in np.argpartition(-S[a], kk - 1)[:kk] if kk > 0 else ():
            b = int(b)
            pairs.add((min(a, b), max(a, b)))
    return np.array(sorted(pairs), np.int32).reshape(-1, 2)


def match_images(feats: features.Features, pairs: np.ndarray,
                 cfg: PipelineConfig) -> MatchResult:
    """Match every listed pair (float descriptors through
    ``match_pairs_float_auto``: K5, or K9 with ``kernel="tiles"``; binary
    words through the plain Hamming matcher)."""
    from ..kernels import matching

    with LOGGER.scope("match", n_pairs=len(pairs), binary=cfg.match.binary) as out:
        if cfg.match.binary:
            # the reference's primary AKAZE path: Hamming on M-LDB bits
            res = matching.match_pairs_hamming(
                feats.desc_bits, feats.kp.mask, pairs,
                ratio=cfg.match.ratio, cross_check=cfg.match.cross_check)
        else:
            res = matching.match_pairs_float_auto(
                feats.desc, feats.kp.mask, pairs,
                ratio=cfg.match.ratio, cross_check=cfg.match.cross_check,
                kernel=cfg.match.kernel)
        out["matches"] = int(res.valid.sum())
    return res


def verify_matches(feats: features.Features, pairs: np.ndarray, res: MatchResult,
                   intrinsics, cam_k, cfg: PipelineConfig, *, chunk: int = 256,
                   generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None):
    """E-RANSAC geometric filter over all matched pairs.

    Runs in pair chunks of ``chunk``; each chunk's (n,H,K) sampling noise is
    drawn from ``generator`` on the features' device, or sliced from an
    injected (Np,H,K) ``gumbel`` (any device).  Returns (a MatchResult
    whose ``valid`` keeps only geometric inliers of pairs with at least
    ``gv_min_inliers`` of them, the (Np,) int32 inlier counts).
    """
    from ..core import cameras
    from ..kernels import matching
    from ..solvers.ransac import gumbel_noise

    dev = feats.desc.device
    intr = np.asarray(intrinsics, np.float32)[np.asarray(cam_k)]  # (C,7)
    xn = cameras.pixel_to_normalized(torch.as_tensor(intr, device=dev)[:, None, :],
                                     feats.kp.uv)
    f_mean = float(np.mean(intr[:, :2]))
    thr = (cfg.match.gv_px_thresh / f_mean) ** 2
    H, K = cfg.match.gv_hypotheses, res.idx.shape[1]
    pairs_t = torch.as_tensor(np.asarray(pairs), device=dev).to(torch.int64)
    inl_parts, cnt_parts = [], []
    for s in range(0, len(pairs_t), chunk):
        e = min(s + chunk, len(pairs_t))
        g = (gumbel[s:e].to(dev) if gumbel is not None
             else gumbel_noise((e - s, H, K), device=dev, generator=generator))
        m = MatchResult(idx=res.idx[s:e], valid=res.valid[s:e], score=res.score[s:e])
        inl, cnt = matching.geometric_verify_pairs(g, xn, feats.kp.mask, pairs_t[s:e], m,
                                                   threshold=thr)
        inl_parts.append(inl)
        cnt_parts.append(cnt)
    if inl_parts:
        inliers, cnt = torch.cat(inl_parts), torch.cat(cnt_parts)
    else:
        inliers = torch.zeros_like(res.valid)
        cnt = torch.zeros((0,), dtype=torch.int32, device=dev)
    new_valid = res.valid & inliers & (cnt >= cfg.match.gv_min_inliers)[:, None]
    return MatchResult(idx=res.idx, valid=new_valid, score=res.score), cnt


def build_front_end(images, intrinsics, cam_k, cfg: PipelineConfig, device, workdir=None, *,
                    feats: features.Features | None = None, stage_seed: str = "",
                    generator: torch.Generator | None = None):
    """The map build up to its reconstruction stage (``sfmx``'s
    ``build_map`` through its extract, pairs, match, verify and tracks
    stages), each stage cached under ``workdir``/stages when given.

    ``images`` (N,H,W) in [0,1], or None with precomputed ``feats`` (then
    ``stage_seed`` keys the cache).  ``generator`` draws the RANSAC noise
    on the features' device; None makes one there seeded 0, whatever
    ``cfg.recon.seed`` is, so a build repeats bit for bit and its verified
    matches do not move with the reconstruction's seed, as the reference's
    (its ``verify_matches`` keys start at seed 0).  Returns
    (feats, pairs (Np,2), verified MatchResult, inlier counts or None,
    TrackTable); every stage writes one LOGGER record.
    """
    from ..recon import tracks as tracks_mod

    n_images = len(cam_k)
    cache = StageCache(workdir, device)
    if feats is None:
        feats = cache.get_or_run("extract", _stage_key("extract", images, cfg.features),
                                 lambda: extract_features(images, cfg, device))
    if generator is None:
        generator = torch.Generator(device=feats.desc.device).manual_seed(0)
    key_basis = images if images is not None else stage_seed
    with LOGGER.scope("pairs", mode=cfg.match.pair_mode) as out:
        if cfg.match.pair_mode == "retrieval":
            pairs = cache.get_or_run(
                "pairs", _stage_key("pairs", key_basis, cfg.features, cfg.match),
                lambda: build_pairs_retrieval(feats, n_images, k=cfg.match.retrieval_k,
                                              window=cfg.match.window))
        else:
            pairs = build_pairs(n_images, cfg.match.pair_mode, cfg.match.window)
        out["n_pairs"] = len(pairs)
    res = cache.get_or_run("match", _stage_key("match", key_basis, cfg.features, cfg.match),
                           lambda: match_images(feats, pairs, cfg))
    cnt = None
    if cfg.match.geometric_verify:
        def _gv():
            with LOGGER.scope("geometric_verify", n_pairs=len(pairs)) as out:
                vres, c = verify_matches(feats, pairs, res, intrinsics, cam_k, cfg,
                                         generator=generator)
                out["inliers"] = int(vres.valid.sum())
                out["pairs_kept"] = int((c >= cfg.match.gv_min_inliers).sum())
            return vres, c

        res, cnt = cache.get_or_run(
            "verify", _stage_key("verify", key_basis, cfg.features, cfg.match), _gv)
    with LOGGER.scope("tracks") as out:
        tt = tracks_mod.build_tracks(pairs, res.idx.cpu().numpy(), res.valid.cpu().numpy(),
                                     n_images, cfg.features.max_keypoints)
        out["tracks"] = tt.n_tracks
    return feats, pairs, res, cnt, tt


def build_map(images, intrinsics, cam_k, cfg: PipelineConfig, device, workdir=None, *,
              feats: features.Features | None = None, stage_seed: str = "",
              generator: torch.Generator | None = None):
    """Full map build on ``device``; returns (scene, feats, track_table, stats).

    The front end is ``build_front_end`` (same arguments; without a
    ``generator`` verification draws from one seeded 0);
    the ``reconstruct`` stage then runs incremental SfM and bundle adjustment
    over its tracks, seeded from ``cfg.recon.seed``.  Direct
    (geometry-verified) per-pair match counts drive the initial-pair
    selection: chained covisibility drifts.
    """
    from ..recon.incremental import reconstruct

    feats, pairs, res, _cnt, tt = build_front_end(
        images, intrinsics, cam_k, cfg, device, workdir, feats=feats, stage_seed=stage_seed,
        generator=generator)
    with LOGGER.scope("reconstruct") as out:
        scene, stats = reconstruct(
            feats.kp.uv.cpu().numpy(), feats.kp.mask.cpu().numpy(), tt,
            np.asarray(intrinsics, np.float32), np.asarray(cam_k, np.int32), cfg.recon,
            pair_counts=(pairs, res.valid.sum(dim=1).cpu().numpy()), device=device)
        out.update({k: v for k, v in stats.items() if isinstance(v, (int, float))})
        # which BA path carried this build, and its throughput
        out["ba_path"] = stats.get("ba_path")
        out["ba_calls"] = stats.get("ba_calls")
        out["components"] = stats.get("components")
        out["phase_s"] = stats.get("phase_s")
        out["ba_call_s"] = stats.get("ba_call_s")
    return scene, feats, tt, stats
