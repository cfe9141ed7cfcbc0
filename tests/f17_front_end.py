"""F17 (ROADMAP.md queue 3): the reference's map-build front end and the
port's on the 1,024-frame corridor of config 4, stage by stage, on the CPU.

The walk is ``sfmx_torch.run_configs.walk(frames, "corridor", 4)`` rendered
at 320x240, f = 280, to 8-bit PNGs and decoded as the command line decodes
them; the settings are ``run_configs.scale_argv``'s (retrieval pairs, k 6,
window ``window_for(frames, "corridor", 4)``, 512 keypoints).  Every part
reads and writes the work directory DIR (large files: keep it outside the
repository) and skips what it finds there already, so a cut run resumes.

Parts, run from the repository root in this order:

    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py frames DIR [FRAMES]
        render and decode the walk (1,024 frames: ~1 min)
    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py ref DIR [VERIFY_SEEDS, e.g. 0-4]
        the reference's front end as its ``build_map`` runs it, a stage at a
        time: ``extract_features`` over chunks of 16, ``build_pairs_retrieval``,
        ``match_images`` over chunks of 512 pairs (the last padded with a
        repeated pair), ``verify_matches(seed=v)`` in its chunks of 256,
        ``build_tracks``; one table ``ref_v<v>.npz`` a verification seed
        (1,024 frames on 6 worker processes: ~18 min to the matches, then
        ~4 min a seed)
    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py port DIR
        the port's front end on the CPU (i) on its own draws, as the command
        line runs it (verification from a generator seeded 0): ``port_own.npz``;
        (ii) in lockstep: its features and matcher on the reference's pair
        list, verification fed the reference's Gumbel rows (per chunk of 256
        at s, ``jax.random.split(PRNGKey(s), 256)``, one (H, K) draw a pair):
        ``port_lock.npz``; (iii) each stage alone on the reference's inputs
        (the reference's features into the port's matcher, its raw matches
        into the port's verification on its draws, its verified matches into
        the port's tracks) (~70 min, beside other work on 8 cores)
    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py ref_eager DIR [CHUNKS]
        the reference's verification of its first CHUNKS chunks of 256
        (all by default) again with ``jax.disable_jit``: its own ops one at a
        time on the same inputs and keys, the yardstick for (iii) (~9 min);
        with every chunk, also the table ``ref_eager.npz``
    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py compare DIR [CARD.npz]
        stage by stage, the reference against (ii), (iii), (i) and the
        card's table (``chip_experiments/f17_inputs.py``'s file): keypoints,
        pairs, raw matches, verified matches, tracks with false tracks
        against the corridor's geometry (a track whose observations' rays
        hit surfaces more than 2 cm apart; also 30 cm, and an observation
        beyond its keypoint's footprint); one JSON line a comparison (~1 min)
    JAX_PLATFORMS=cpu python3 tests/f17_front_end.py fixture DIR OUT.npz
        from a run of ``ref`` at 48 frames: ``tests/test_torch_f17.py``'s
        fixture (the reference's keypoints, pair list and raw matches)

The tables ``ref_v<v>.npz``, ``port_own.npz`` and ``port_lock.npz`` have
the fields ``tests/f17_builds.py`` reads, so both packages' ``reconstruct``
replay them:
    JAX_PLATFORMS=cpu python3 tests/f17_builds.py DIR/ref_v0.npz 0-4 ref,port
"""
import dataclasses
import functools
import json
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCENE, ROOMS = "corridor", 4
EXTRACT_CHUNK, MATCH_CHUNK, VERIFY_CHUNK = 16, 512, 256
WORKERS = 6
FALSE_TRACK_M = 0.02      # the corridor's depths are 4.7-13 m: a pixel spans 1.7-4.7 cm there
FAR_TRACK_M = 0.3


# ---------------------------------------------------------------------------
# Settings and files
# ---------------------------------------------------------------------------


def overrides(frames: int) -> list[str]:
    """The ``-D`` overrides of ``run_configs.scale_argv`` (config 4-build's
    and 2+'s command line) at ``frames``."""
    from sfmx_torch import run_configs as rc

    argv = rc.scale_argv(frames, Path("."), "cpu", scene=SCENE, rooms=ROOMS)
    return [argv[i + 1] for i, a in enumerate(argv) if a == "-D"]


def ref_config(frames: int):
    from sfmx.cli.config import load_config

    return load_config(None, overrides(frames))


def port_config(frames: int):
    from sfmx_torch.cli.config import load_config

    return load_config(None, overrides(frames))


def intrinsics(frames: int) -> np.ndarray:
    from sfmx_torch.cli import ingest

    cfg = port_config(frames)
    return ingest.default_intrinsics(*cfg.resize_to, cfg.focal_factor)[None]


def n_frames(d: Path) -> int:
    return int(np.load(d / "eyes.npy").shape[0])


def save_npz(path: Path, **arrays):
    tmp = path.with_suffix(".part.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _quiet():
    """Stage functions log a JSON line each; keep them off the output."""
    import io

    from sfmx.utils.logging import LOGGER as JL
    from sfmx_torch.utils.logging import LOGGER as TL

    JL._stream = TL._stream = io.StringIO()


def _pool(n: int = WORKERS):
    import multiprocessing as mp

    return ProcessPoolExecutor(n, mp_context=mp.get_context("spawn"))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def part_frames(d: Path, frames: int = 1024):
    """Render the walk to PNGs and decode them as ``build-map`` does."""
    from sfmx_torch import run_configs as rc
    from sfmx_torch.cli import ingest

    d.mkdir(parents=True, exist_ok=True)
    if (d / "frames.npy").exists():
        return
    poses, _render = rc.walk(frames, SCENE, ROOMS)
    imgs = d / "imgs"
    imgs.mkdir(exist_ok=True)
    rc._examples().render_walk_parallel(SCENE, ROOMS, poses, imgs, workers=WORKERS)
    paths = ingest.list_images(imgs)
    assert len(paths) == frames, len(paths)
    W, H = port_config(frames).resize_to
    out = np.stack([ingest._load_gray(p, (W, H))[0] for p in paths])
    np.save(d / "frames.npy", out)
    np.save(d / "eyes.npy", np.stack([e for (_, _, e) in poses]).astype(np.float32))
    np.save(d / "cam_R.npy", np.stack([R for (R, _, _) in poses]).astype(np.float64))
    print(json.dumps({"frames": frames, "shape": list(out.shape)}), flush=True)


# ---------------------------------------------------------------------------
# The reference's front end
# ---------------------------------------------------------------------------


def ref_feats(d: Path):
    """The reference's saved features as its ``Features`` record."""
    import jax.numpy as jnp

    from sfmx.kernels.features import Features, Keypoints

    z = np.load(d / "ref_feats.npz")
    kp = Keypoints(*(jnp.asarray(z[k]) for k in Keypoints._fields))
    return Features(kp, jnp.asarray(z["desc"]), jnp.zeros((0,), jnp.uint32))


def _ref_extract_chunk(args):
    d, s, e = args
    _jax_cpu()
    _quiet()
    from sfmx.cli import pipeline as jp

    imgs = np.load(Path(d) / "frames.npy", mmap_mode="r")[s:e]
    f = jp._extract_raw(np.ascontiguousarray(imgs), ref_config(n_frames(Path(d))))
    return s, {**{k: np.asarray(v) for k, v in f.kp._asdict().items()},
               "desc": np.asarray(f.desc)}


def _ref_match_chunk(args):
    d, s, e = args
    _jax_cpu()
    _quiet()
    from sfmx.cli import pipeline as jp

    d = Path(d)
    pairs = np.load(d / "ref_pairs.npy")
    p = pairs[s:e]
    p = np.concatenate([p, np.repeat(p[-1:], MATCH_CHUNK - len(p), axis=0)])
    r = jp.match_images(ref_feats(d), p, ref_config(n_frames(d)))
    n = e - s
    return s, (np.asarray(r.idx)[:n].astype(np.int16), np.asarray(r.valid)[:n],
               np.asarray(r.score)[:n])


def _ref_verify_range(args):
    """``verify_matches`` over pairs [s, e) (s a multiple of its chunk):
    its keys are PRNGKey(seed + s') for the chunk at s' of this range, so
    ``seed + s`` continues the whole list's sequence."""
    d, seed, s, e = args
    _jax_cpu()
    _quiet()
    import jax.numpy as jnp

    from sfmx.cli import pipeline as jp
    from sfmx.kernels.matching import MatchResult

    d = Path(d)
    frames = n_frames(d)
    pairs = np.load(d / "ref_pairs.npy")[s:e]
    raw = np.load(d / "ref_match.npz")
    res = MatchResult(idx=jnp.asarray(raw["idx"][s:e].astype(np.int32)),
                      valid=jnp.asarray(raw["valid"][s:e]), score=None)
    v, cnt = jp.verify_matches(ref_feats(d), pairs, res, intrinsics(frames),
                               np.zeros(frames, np.int32), ref_config(frames),
                               seed=seed + s, chunk=VERIFY_CHUNK)
    return s, (np.asarray(v.valid), np.asarray(cnt).astype(np.int32))


def _ref_verify_eager(args):
    """``_ref_verify_range`` at seed 0 with jit disabled: the reference's
    own ops one at a time, without XLA's fusion of its jitted chunk."""
    jax = _jax_cpu()
    with jax.disable_jit():
        return _ref_verify_range((args[0], 0, *args[1:]))


def _ranges(n: int, step: int, parts: int):
    """[s, e) ranges over n in multiples of step, about n / parts long."""
    per = max(step, -(-n // parts // step) * step)
    return [(s, min(s + per, n)) for s in range(0, n, per)]


def part_ref(d: Path, verify_seeds=(0,)):
    _jax_cpu()
    frames = n_frames(d)
    t0 = time.time()
    if not (d / "ref_feats.npz").exists():
        parts = {}
        with _pool() as ex:
            for s, f in ex.map(_ref_extract_chunk, [(str(d), s, min(s + EXTRACT_CHUNK, frames))
                                                    for s in range(0, frames, EXTRACT_CHUNK)]):
                parts[s] = f
        cat = {k: np.concatenate([parts[s][k] for s in sorted(parts)]) for k in parts[0]}
        save_npz(d / "ref_feats.npz", **cat)
        print(json.dumps({"ref": "extract", "keypoints": int(cat["mask"].sum()),
                          "s": round(time.time() - t0, 1)}), flush=True)
    if not (d / "ref_pairs.npy").exists():
        _quiet()
        import jax
        import jax.numpy as jnp

        from sfmx.cli import pipeline as jp

        cfg = ref_config(frames)
        feats = ref_feats(d)
        pairs = jp.build_pairs_retrieval(feats, frames, k=cfg.match.retrieval_k,
                                         window=cfg.match.window)
        # the vocabulary's first word, as build_vocabulary draws it
        fmask = np.asarray(feats.kp.mask).reshape(-1)
        stride = max(1, fmask.shape[0] // 32768)
        m = jnp.asarray(fmask[::stride])
        first = int(jax.random.choice(jax.random.PRNGKey(0), m.shape[0],
                                      p=m.astype(jnp.float32) / jnp.maximum(m.sum(), 1)))
        np.save(d / "ref_first.npy", np.int64(first))
        np.save(d / "ref_pairs.npy", pairs)
        print(json.dumps({"ref": "pairs", "n_pairs": len(pairs), "first": first,
                          "s": round(time.time() - t0, 1)}), flush=True)
    pairs = np.load(d / "ref_pairs.npy")
    if not (d / "ref_match.npz").exists():
        out = {}
        with _pool() as ex:
            for s, r in ex.map(_ref_match_chunk, [(str(d), s, min(s + MATCH_CHUNK, len(pairs)))
                                                  for s in range(0, len(pairs), MATCH_CHUNK)]):
                out[s] = r
        idx, valid, score = (np.concatenate([out[s][i] for s in sorted(out)]) for i in range(3))
        save_npz(d / "ref_match.npz", idx=idx, valid=valid, score=score)
        print(json.dumps({"ref": "match", "matches": int(valid.sum()),
                          "s": round(time.time() - t0, 1)}), flush=True)
    for v in verify_seeds:
        if not (d / f"ref_verify_v{v}.npz").exists():
            out = {}
            with _pool() as ex:
                for s, r in ex.map(_ref_verify_range,
                                   [(str(d), v, s, e) for s, e in
                                    _ranges(len(pairs), VERIFY_CHUNK, 4 * WORKERS)]):
                    out[s] = r
            valid = np.concatenate([out[s][0] for s in sorted(out)])
            cnt = np.concatenate([out[s][1] for s in sorted(out)])
            save_npz(d / f"ref_verify_v{v}.npz", valid=valid, cnt=cnt)
            print(json.dumps({"ref": "verify", "seed": v, "inliers": int(valid.sum()),
                              "s": round(time.time() - t0, 1)}), flush=True)
        if not (d / f"ref_v{v}.npz").exists():
            from sfmx.recon import tracks as jtracks

            z, ver = np.load(d / "ref_feats.npz"), np.load(d / f"ref_verify_v{v}.npz")
            idx = np.load(d / "ref_match.npz")["idx"].astype(np.int32)
            tt = jtracks.build_tracks(pairs, idx, ver["valid"], frames,
                                      ref_config(frames).features.max_keypoints)
            write_table(d / f"ref_v{v}.npz", d, z["uv"], z["mask"], tt, pairs,
                        ver["valid"].sum(axis=1))
            print(json.dumps({"ref": "tracks", "seed": v, "tracks": int(tt.n_tracks),
                              "s": round(time.time() - t0, 1)}), flush=True)


def part_ref_eager(d: Path, chunks: int):
    """The reference's verification of its first ``chunks`` chunks again,
    eagerly: how far its own results move with the rounding of another
    evaluation order, on the same inputs and keys."""
    if (d / "ref_verify_eager.npz").exists():
        return
    t0 = time.time()
    n = min(len(np.load(d / "ref_pairs.npy")), chunks * VERIFY_CHUNK)
    out = {}
    with _pool() as ex:
        for s, r in ex.map(_ref_verify_eager, [(str(d), s, min(s + VERIFY_CHUNK, n))
                                               for s in range(0, n, VERIFY_CHUNK)]):
            out[s] = r
    valid = np.concatenate([out[s][0] for s in sorted(out)])
    cnt = np.concatenate([out[s][1] for s in sorted(out)])
    save_npz(d / "ref_verify_eager.npz", valid=valid, cnt=cnt)
    rec = {"ref": "verify eager", "pairs": n, "inliers": int(valid.sum())}
    pairs = np.load(d / "ref_pairs.npy")
    if n == len(pairs):
        from sfmx.recon import tracks as jtracks

        frames = n_frames(d)
        z = np.load(d / "ref_feats.npz")
        idx = np.load(d / "ref_match.npz")["idx"].astype(np.int32)
        tt = jtracks.build_tracks(pairs, idx, valid, frames,
                                  ref_config(frames).features.max_keypoints)
        write_table(d / "ref_eager.npz", d, z["uv"], z["mask"], tt, pairs, valid.sum(axis=1))
        rec["tracks"] = int(tt.n_tracks)
    print(json.dumps({**rec, "s": round(time.time() - t0, 1)}), flush=True)


def write_table(path: Path, d: Path, kp_uv, kp_mask, tt, pairs, pair_counts):
    """A ``reconstruct`` input table as ``chip_experiments/f17_inputs.py``
    writes it (``tests/f17_builds.py`` reads it)."""
    frames = n_frames(d)
    cfg = port_config(frames)
    save_npz(path, kp_uv=np.asarray(kp_uv, np.float32), kp_mask=np.asarray(kp_mask, bool),
             obs_cam=np.asarray(tt.obs_cam), obs_feat=np.asarray(tt.obs_feat),
             obs_track=np.asarray(tt.obs_track), n_tracks=int(tt.n_tracks),
             intr=intrinsics(frames), cam_k=np.zeros(frames, np.int32),
             pairs=np.asarray(pairs), pair_counts=np.asarray(pair_counts),
             seed=cfg.recon.seed, recon=json.dumps(dataclasses.asdict(cfg.recon)),
             eyes=np.load(d / "eyes.npy"))


# ---------------------------------------------------------------------------
# The port's front end
# ---------------------------------------------------------------------------


def _torch_threads(n: int = 1):
    import torch

    torch.set_num_threads(n)
    return torch


def port_feats_of(z):
    """A port ``Features`` on the CPU from saved keypoint fields and desc."""
    import torch

    from sfmx_torch.kernels.features import Features, Keypoints

    kp = Keypoints(*(torch.as_tensor(z[k]) for k in Keypoints._fields))
    kp = kp._replace(level=kp.level.to(torch.int64))
    return Features(kp, torch.as_tensor(z["desc"]), torch.zeros((0,), dtype=torch.int32))


def _port_extract_chunk(args):
    d, s, e = args
    _torch_threads(1)
    _quiet()
    from sfmx_torch.cli import pipeline as tp

    imgs = np.load(Path(d) / "frames.npy", mmap_mode="r")[s:e]
    f = tp._extract_raw(np.ascontiguousarray(imgs), port_config(n_frames(Path(d))), "cpu")
    return s, {**{k: v.numpy() for k, v in f.kp._asdict().items()}, "desc": f.desc.numpy()}


def _port_match_chunk(args):
    """The port's matcher on pairs [s, e) of ``pairs_file`` with the
    features of ``feats_file``."""
    d, feats_file, pairs_file, s, e = args
    _torch_threads(1)
    _quiet()
    from sfmx_torch.cli import pipeline as tp

    d = Path(d)
    feats = port_feats_of(np.load(d / feats_file))
    r = tp.match_images(feats, np.load(d / pairs_file)[s:e], port_config(n_frames(d)))
    return s, (r.idx.numpy().astype(np.int16), r.valid.numpy(), r.score.numpy())


def ref_gumbel_rows(s: int, n: int, H: int, K: int, seed: int = 0):
    """The reference's verification draws for the chunk at s with n real
    pairs: PRNGKey(seed + s) split over the padded chunk, one (H, K)
    Gumbel a pair (``sfmx/cli/pipeline.py:verify_matches``,
    ``geometric_verify_pairs``, ``ransac.sample_minimal``)."""
    jax = _jax_cpu()
    keys = jax.random.split(jax.random.PRNGKey(seed + s), VERIFY_CHUNK)[:n]
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (H, K)))(keys))


def _port_verify_range(args):
    """The port's ``verify_matches`` over pairs [s, e) on the reference's
    draws, chunk by chunk."""
    d, feats_file, pairs_file, match_file, seed, s, e = args
    torch = _torch_threads(1)
    _quiet()
    from sfmx_torch.cli import pipeline as tp
    from sfmx_torch.kernels.matching import MatchResult

    d = Path(d)
    frames = n_frames(d)
    cfg = port_config(frames)
    feats = port_feats_of(np.load(d / feats_file))
    pairs = np.load(d / pairs_file)
    raw = np.load(d / match_file)
    H, K = cfg.match.gv_hypotheses, raw["idx"].shape[1]
    vs, cs = [], []
    for c in range(s, e, VERIFY_CHUNK):
        ce = min(c + VERIFY_CHUNK, e)
        res = MatchResult(idx=torch.as_tensor(raw["idx"][c:ce].astype(np.int64)),
                          valid=torch.as_tensor(raw["valid"][c:ce]),
                          score=torch.zeros((ce - c, K)))
        g = torch.as_tensor(ref_gumbel_rows(c, ce - c, H, K, seed))
        v, cnt = tp.verify_matches(feats, pairs[c:ce], res, intrinsics(frames),
                                   np.zeros(frames, np.int32), cfg, chunk=VERIFY_CHUNK,
                                   gumbel=g)
        vs.append(v.valid.numpy())
        cs.append(cnt.numpy())
    return s, (np.concatenate(vs), np.concatenate(cs))


def _match_all(d: Path, feats_file: str, pairs_file: str, out_file: str):
    if (d / out_file).exists():
        return
    n = len(np.load(d / pairs_file))
    out = {}
    with _pool() as ex:
        for s, r in ex.map(_port_match_chunk, [(str(d), feats_file, pairs_file, s,
                                                min(s + MATCH_CHUNK, n))
                                               for s in range(0, n, MATCH_CHUNK)]):
            out[s] = r
    idx, valid, score = (np.concatenate([out[s][i] for s in sorted(out)]) for i in range(3))
    save_npz(d / out_file, idx=idx, valid=valid, score=score)


def _verify_lockstep(d: Path, feats_file: str, pairs_file: str, match_file: str,
                     out_file: str, seed: int = 0):
    if (d / out_file).exists():
        return
    n = len(np.load(d / pairs_file))
    out = {}
    with _pool() as ex:
        for s, r in ex.map(_port_verify_range,
                           [(str(d), feats_file, pairs_file, match_file, seed, s, e)
                            for s, e in _ranges(n, VERIFY_CHUNK, 4 * WORKERS)]):
            out[s] = r
    valid = np.concatenate([out[s][0] for s in sorted(out)])
    cnt = np.concatenate([out[s][1] for s in sorted(out)])
    save_npz(d / out_file, valid=valid, cnt=cnt)


def _port_tracks(d: Path, pairs, idx, valid):
    from sfmx_torch.recon import tracks as ttracks

    frames = n_frames(d)
    return ttracks.build_tracks(pairs, idx.astype(np.int64), valid, frames,
                                port_config(frames).features.max_keypoints)


def part_port(d: Path):
    torch = _torch_threads(WORKERS)
    _quiet()
    from sfmx_torch.cli import pipeline as tp

    frames = n_frames(d)
    cfg = port_config(frames)
    t0 = time.time()
    log = lambda **kw: print(json.dumps({**kw, "s": round(time.time() - t0, 1)}), flush=True)
    if not (d / "port_feats.npz").exists():
        parts = {}
        with _pool() as ex:
            for s, f in ex.map(_port_extract_chunk, [(str(d), s, min(s + EXTRACT_CHUNK, frames))
                                                     for s in range(0, frames, EXTRACT_CHUNK)]):
                parts[s] = f
        cat = {k: np.concatenate([parts[s][k] for s in sorted(parts)]) for k in parts[0]}
        save_npz(d / "port_feats.npz", **cat)
        log(port="extract", keypoints=int(cat["mask"].sum()))
    feats = port_feats_of(np.load(d / "port_feats.npz"))
    if not (d / "port_pairs.npy").exists():
        own = tp.build_pairs_retrieval(feats, frames, k=cfg.match.retrieval_k,
                                       window=cfg.match.window)
        at_ref_first = tp.build_pairs_retrieval(feats, frames, k=cfg.match.retrieval_k,
                                                window=cfg.match.window,
                                                first=int(np.load(d / "ref_first.npy")))
        np.save(d / "port_pairs_ref_first.npy", at_ref_first)
        np.save(d / "port_pairs.npy", own)
        log(port="pairs", n_pairs=len(own), at_ref_first=len(at_ref_first))
    # (i) on its own draws, as the command line runs it
    if not (d / "port_own.npz").exists():
        pairs = np.load(d / "port_pairs.npy")
        _match_all(d, "port_feats.npz", "port_pairs.npy", "port_match_own.npz")
        raw = np.load(d / "port_match_own.npz")
        from sfmx_torch.kernels.matching import MatchResult

        res = MatchResult(idx=torch.as_tensor(raw["idx"].astype(np.int64)),
                          valid=torch.as_tensor(raw["valid"]),
                          score=torch.as_tensor(raw["score"]))
        v, cnt = tp.verify_matches(feats, pairs, res, intrinsics(frames),
                                   np.zeros(frames, np.int32), cfg,
                                   generator=torch.Generator().manual_seed(0))
        save_npz(d / "port_verify_own.npz", valid=v.valid.numpy(), cnt=cnt.numpy())
        tt = _port_tracks(d, pairs, raw["idx"], v.valid.numpy())
        write_table(d / "port_own.npz", d, feats.kp.uv.numpy(), feats.kp.mask.numpy(), tt,
                    pairs, v.valid.numpy().sum(axis=1))
        log(port="own", inliers=int(v.valid.sum()), tracks=int(tt.n_tracks))
    # (ii) in lockstep: the reference's pair list and verification draws
    if not (d / "port_lock.npz").exists():
        pairs = np.load(d / "ref_pairs.npy")
        _match_all(d, "port_feats.npz", "ref_pairs.npy", "port_match_lock.npz")
        _verify_lockstep(d, "port_feats.npz", "ref_pairs.npy", "port_match_lock.npz",
                         "port_verify_lock.npz")
        raw, ver = np.load(d / "port_match_lock.npz"), np.load(d / "port_verify_lock.npz")
        tt = _port_tracks(d, pairs, raw["idx"], ver["valid"])
        write_table(d / "port_lock.npz", d, feats.kp.uv.numpy(), feats.kp.mask.numpy(), tt,
                    pairs, ver["valid"].sum(axis=1))
        log(port="lockstep", inliers=int(ver["valid"].sum()), tracks=int(tt.n_tracks))
    # (iii) each stage alone on the reference's inputs and draws
    if not (d / "stage_tracks.npz").exists():
        _match_all(d, "ref_feats.npz", "ref_pairs.npy", "stage_match.npz")
        _verify_lockstep(d, "ref_feats.npz", "ref_pairs.npy", "ref_match.npz",
                         "stage_verify.npz")
        pairs = np.load(d / "ref_pairs.npy")
        idx = np.load(d / "ref_match.npz")["idx"]
        tt = _port_tracks(d, pairs, idx, np.load(d / "ref_verify_v0.npz")["valid"])
        save_npz(d / "stage_tracks.npz", obs_cam=tt.obs_cam, obs_feat=tt.obs_feat,
                 obs_track=tt.obs_track, n_tracks=int(tt.n_tracks))
        log(port="stages")


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------


def corridor_hits(R: np.ndarray, eye: np.ndarray, uv: np.ndarray, intr: np.ndarray):
    """World points where the pixel rays uv (N,2) of a camera (R world to
    camera, centre eye) first hit the corridor's rectangles, as
    ``examples.room.render_corridor`` casts them (nearest hit wins)."""
    cor = _corridor()
    d = np.concatenate([(uv - intr[2:4]) / intr[0:2], np.ones((len(uv), 1))], axis=1) @ R
    best = np.full(len(uv), np.inf)
    for axis, coord, ua, u0, u1, va, v0, v1 in cor.rects:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (coord - eye[axis]) / d[:, axis]
            t = np.where(np.abs(d[:, axis]) < 1e-12, np.inf, t)
            pu, pv = eye[ua] + t * d[:, ua], eye[va] + t * d[:, va]
            inside = ((t > 1e-6) & (pu >= u0 - 1e-6) & (pu <= u1 + 1e-6)
                      & (pv >= v0 - 1e-6) & (pv <= v1 + 1e-6))
        best = np.where(inside & (t < best), t, best)
    return eye[None, :] + best[:, None] * d


@functools.lru_cache(maxsize=1)
def _corridor():
    from sfmx_torch import run_configs as rc

    return rc._examples().Corridor(n_rooms=ROOMS, seed=7)


def track_stats(d: Path, t: dict, kp_uv, kp_sigma=None) -> dict:
    """Tracks of table t: count, observations, a length histogram, and
    false tracks against the corridor: those whose observations' ray hits
    lie more than FALSE_TRACK_M (and FAR_TRACK_M) apart, and (with the keypoints' scales)
    those with an observation farther from the track's median hit than its
    footprint, max(FALSE_TRACK_M, sigma x depth / f), as chip_smoke.py's
    truth gates judge a room track."""
    eyes, Rs = np.load(d / "eyes.npy").astype(np.float64), np.load(d / "cam_R.npy")
    intr = intrinsics(len(eyes))[0].astype(np.float64)
    obs_cam, obs_feat, n_tracks = t["obs_cam"], t["obs_feat"], t["n_tracks"]
    hits = np.zeros((len(obs_cam), 3))
    for c in np.unique(obs_cam):
        o = np.flatnonzero(obs_cam == c)
        hits[o] = corridor_hits(Rs[c], eyes[c], kp_uv[c, obs_feat[o]].astype(np.float64), intr)
    tol = np.full(len(obs_cam), FALSE_TRACK_M)
    if kp_sigma is not None:
        depth = np.linalg.norm(hits - eyes[obs_cam], axis=1)
        tol = np.maximum(tol, kp_sigma[obs_cam, obs_feat] * depth / intr[0])
    order = np.argsort(t["obs_track"], kind="stable")
    starts = np.searchsorted(t["obs_track"][order], np.arange(n_tracks))
    lengths = np.diff(np.append(starts, len(order)))
    spread, beyond = np.zeros(n_tracks), np.zeros(n_tracks, bool)
    n_obs_beyond = 0
    for k, (s, n) in enumerate(zip(starts, lengths)):
        o = order[s:s + n]
        h = hits[o]
        spread[k] = max(np.sqrt(((h[i:i + 512, None] - h[None]) ** 2).sum(-1)).max()
                        for i in range(0, n, 512))
        out = np.linalg.norm(h - np.median(h, axis=0), axis=1) > tol[o]
        beyond[k] = out.any()
        n_obs_beyond += int(out.sum())
    false, far = spread > FALSE_TRACK_M, spread > FAR_TRACK_M
    bins = [2, 3, 4, 5, 9, 17, 33, 10 ** 9]
    hist = {(f"{a}-{b - 1}" if b < 10 ** 9 else f"{a}+") if b - 1 > a else str(a):
            int(((lengths >= a) & (lengths < b)).sum()) for a, b in zip(bins[:-1], bins[1:])}
    return {"tracks": int(n_tracks), "observations": int(len(obs_cam)), "length_hist": hist,
            "false_2cm": int(false.sum()), "false_2cm_share": round(float(false.mean()), 5),
            "false_30cm": int(far.sum()), "false_30cm_share": round(float(far.mean()), 5),
            "false_footprint": int(beyond.sum()),
            "false_footprint_share": round(float(beyond.mean()), 5),
            "obs_beyond_footprint_share": round(n_obs_beyond / max(len(obs_cam), 1), 5)}


def keypoint_stats(a_uv, a_mask, b_uv, b_mask, tol: float = 0.01) -> dict:
    """Keypoints of b against a: counts, slots where both are valid and
    within tol px, and each of b's nearest neighbours in a within tol."""
    both = a_mask & b_mask
    dslot = np.linalg.norm(a_uv - b_uv, axis=-1)
    n_matched, worst = 0, 0.0
    for c in range(len(a_uv)):
        A, B = a_uv[c][a_mask[c]], b_uv[c][b_mask[c]]
        if not len(A) or not len(B):
            continue
        dist = np.sqrt(((B[:, None] - A[None]) ** 2).sum(-1)).min(axis=1)
        ok = dist <= tol
        n_matched += int(ok.sum())
        worst = max(worst, float(dist[ok].max()) if ok.any() else 0.0)
    return {"a": int(a_mask.sum()), "b": int(b_mask.sum()),
            "slots_within": int((both & (dslot <= tol)).sum()),
            "nn_within": n_matched, "nn_within_share": round(n_matched / max(b_mask.sum(), 1), 6),
            "max_diff_within_px": worst}


def match_stats(pa, a_idx, a_valid, pb, b_idx, b_valid) -> dict:
    """Per-pair match lists of b against a over their common pairs."""
    key = lambda p: p[:, 0].astype(np.int64) * 100000 + p[:, 1]
    ka, kb = key(pa), key(pb)
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    av, bv = a_valid[ia], b_valid[ib]
    ai = np.where(av, a_idx[ia], -1)
    bi = np.where(bv, b_idx[ib], -1)
    equal = (ai == bi).all(axis=1)
    ca, cb = av.sum(axis=1), bv.sum(axis=1)
    return {"pairs_a": len(pa), "pairs_b": len(pb), "common": len(common),
            "matches_a": int(ca.sum()), "matches_b": int(cb.sum()),
            "equal_pairs_share": round(float(equal.mean()), 6),
            "count_abs_diff_mean": round(float(np.abs(ca - cb).mean()), 4),
            "count_abs_diff_max": int(np.abs(ca - cb).max()),
            "entries_differ": int((ai != bi).sum())}


def verify_stats(pa, a_valid, pb, b_valid, min_inliers: int) -> dict:
    """Verified inliers per pair of b against a over their common pairs."""
    out = match_stats(pa, np.zeros_like(a_valid, np.int32), a_valid,
                      pb, np.zeros_like(b_valid, np.int32), b_valid)
    key = lambda p: p[:, 0].astype(np.int64) * 100000 + p[:, 1]
    _, ia, ib = np.intersect1d(key(pa), key(pb), return_indices=True)
    ka, kb = a_valid[ia].sum(axis=1) >= min_inliers, b_valid[ib].sum(axis=1) >= min_inliers
    kept = ka | kb
    same = (a_valid[ia] == b_valid[ib]).all(axis=1)
    return {"inliers_a": out["matches_a"], "inliers_b": out["matches_b"],
            "kept_a": int(ka.sum()), "kept_b": int(kb.sum()), "kept_both": int((ka & kb).sum()),
            "equal_masks_share": out["equal_pairs_share"],
            "equal_masks_share_of_kept": round(float(same[kept].mean()), 6) if kept.any() else 1.0,
            "count_abs_diff_mean": out["count_abs_diff_mean"],
            "count_abs_diff_max": out["count_abs_diff_max"]}


def load_table(path: Path) -> dict:
    z = dict(np.load(path))
    z["n_tracks"] = int(z["n_tracks"])
    return z


def part_compare(d: Path, card: str | None = None):
    frames = n_frames(d)
    min_inl = port_config(frames).match.gv_min_inliers
    rf, pf = np.load(d / "ref_feats.npz"), np.load(d / "port_feats.npz")
    rp = np.load(d / "ref_pairs.npy")
    rm = np.load(d / "ref_match.npz")
    rv = np.load(d / "ref_verify_v0.npz")["valid"]
    rt = load_table(d / "ref_v0.npz")
    out = lambda **kw: print(json.dumps(kw), flush=True)
    ref_tracks = lambda t: track_stats(d, t, rf["uv"], rf["sigma"])
    out(compare="ref, verification seed 0", tracks=ref_tracks(rt))
    for v in range(1, 5):
        if (d / f"ref_v{v}.npz").exists():
            out(compare=f"ref, verification seed {v} against seed 0",
                verify=verify_stats(rp, rv, rp, np.load(d / f"ref_verify_v{v}.npz")["valid"],
                                    min_inl),
                tracks=ref_tracks(load_table(d / f"ref_v{v}.npz")))
    if (d / "ref_verify_eager.npz").exists():
        ev = np.load(d / "ref_verify_eager.npz")["valid"]
        n = len(ev)
        rec = {"pairs": n, "verify": verify_stats(rp[:n], rv[:n], rp[:n], ev, min_inl)}
        if (d / "ref_eager.npz").exists():
            rec["tracks"] = ref_tracks(load_table(d / "ref_eager.npz"))
        out(compare="ref jitted against ref eager (same inputs, same keys)", **rec)
    # (iii) each stage alone on the reference's inputs
    if (d / "stage_tracks.npz").exists():
        sm, sv = np.load(d / "stage_match.npz"), np.load(d / "stage_verify.npz")["valid"]
        st = load_table(d / "stage_tracks.npz")
        same = st["n_tracks"] == rt["n_tracks"] and all(
            np.array_equal(st[k], rt[k]) for k in ("obs_cam", "obs_feat", "obs_track"))
        out(compare="(iii) port stages alone on the reference's inputs and draws",
            match=match_stats(rp, rm["idx"], rm["valid"], rp, sm["idx"], sm["valid"]),
            verify=verify_stats(rp, rv, rp, sv, min_inl),
            tracks_equal=bool(same), tracks=int(st["n_tracks"]))
    kps = keypoint_stats(rf["uv"], rf["mask"], pf["uv"], pf["mask"])
    both = rf["mask"] & pf["mask"] & (np.linalg.norm(rf["uv"] - pf["uv"], axis=-1) <= 0.01)
    dd = np.abs(rf["desc"][both] - pf["desc"][both]).max(axis=-1)
    kps.update(desc_max_diff=float(dd.max()),
               desc_share_over_1e4=round(float((dd > 1e-4).mean()), 6))
    pp, ppr = np.load(d / "port_pairs.npy"), np.load(d / "port_pairs_ref_first.npy")
    out(compare="keypoints and pairs, port against ref", keypoints=kps,
        pairs=pair_stats(rp, pp), pairs_at_ref_first=pair_stats(rp, ppr))
    for name, m, v, t, p in (
            ("(ii) lockstep", "port_match_lock.npz", "port_verify_lock.npz", "port_lock.npz",
             rp),
            ("(i) own draws", "port_match_own.npz", "port_verify_own.npz", "port_own.npz", pp)):
        if (d / t).exists():
            mm, vv = np.load(d / m), np.load(d / v)["valid"]
            out(compare=name, match=match_stats(rp, rm["idx"], rm["valid"], p, mm["idx"],
                                                mm["valid"]),
                verify=verify_stats(rp, rv, p, vv, min_inl),
                tracks=track_stats(d, load_table(d / t), pf["uv"], pf["sigma"]))
    if card:
        c = load_table(Path(card))
        rec = {"keypoints": keypoint_stats(rf["uv"], rf["mask"], c["kp_uv"], c["kp_mask"]),
               "keypoints_against_port_cpu": keypoint_stats(pf["uv"], pf["mask"], c["kp_uv"],
                                                            c["kp_mask"]),
               "pairs": pair_stats(rp, c["pairs"])}
        if "raw_valid" in c:
            shape = (len(c["pairs"]), c["kp_uv"].shape[1])
            unpack = lambda bits: np.unpackbits(bits, count=shape[0] * shape[1]).reshape(
                shape).astype(bool)
            raw_valid, ver_valid = unpack(c["raw_valid"]), unpack(c["ver_valid"])
            raw_idx = np.zeros(shape, np.int32)
            raw_idx[raw_valid] = c["raw_idx"]
            rec["match"] = match_stats(rp, rm["idx"], rm["valid"], c["pairs"], raw_idx,
                                       raw_valid)
            rec["verify"] = verify_stats(rp, rv, c["pairs"], ver_valid, min_inl)
            mo = np.load(d / "port_match_own.npz")
            rec["match_against_port_cpu"] = match_stats(pp, mo["idx"], mo["valid"], c["pairs"],
                                                        raw_idx, raw_valid)
        rec["tracks"] = track_stats(d, c, c["kp_uv"], c.get("kp_sigma"))
        out(compare="card", **rec)


def pair_stats(a, b) -> dict:
    key = lambda p: p[:, 0].astype(np.int64) * 100000 + p[:, 1]
    return {"a": len(a), "b": len(b), "common": len(np.intersect1d(key(a), key(b))),
            "equal": bool(a.shape == b.shape and np.array_equal(a, b))}


# ---------------------------------------------------------------------------
# fixture
# ---------------------------------------------------------------------------


def part_fixture(d: Path, out: Path):
    """The pin's inputs from a ``ref`` run: the reference's keypoints, its
    pair list and its raw matches (indices where valid)."""
    frames = n_frames(d)
    rf, rm = np.load(d / "ref_feats.npz"), np.load(d / "ref_match.npz")
    np.savez_compressed(out, frames=frames, kp_uv=rf["uv"], kp_mask=rf["mask"],
                        pairs=np.load(d / "ref_pairs.npy"), raw_valid=np.packbits(rm["valid"]),
                        raw_idx=rm["idx"][rm["valid"]].astype(np.int16))
    print(json.dumps({"fixture": str(out), "bytes": out.stat().st_size}), flush=True)


def main() -> int:
    part, d = sys.argv[1], Path(sys.argv[2])
    if part == "frames":
        part_frames(d, int(sys.argv[3]) if len(sys.argv) > 3 else 1024)
    elif part == "ref":
        lo, hi = (int(x) for x in (sys.argv[3] if len(sys.argv) > 3 else "0-0").split("-"))
        part_ref(d, range(lo, hi + 1))
    elif part == "ref_eager":
        part_ref_eager(d, int(sys.argv[3]) if len(sys.argv) > 3 else 10 ** 9)
    elif part == "port":
        part_port(d)
    elif part == "compare":
        part_compare(d, sys.argv[3] if len(sys.argv) > 3 else None)
    elif part == "fixture":
        part_fixture(d, Path(sys.argv[3]))
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
