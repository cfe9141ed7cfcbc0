"""Both packages' ``reconstruct`` on one track table with the SAME RANSAC
draws, round by round (F15 in ROADMAP.md).

``save`` renders one of config 5-serve's sessions, runs the port's front end
on it on the CPU (``sfmx_torch.cli.pipeline.build_front_end``, the inputs
``build_map`` gives ``reconstruct``) and writes them to an ``.npz``.
``run`` feeds that file to ``sfmx.recon.incremental.reconstruct`` and to
``sfmx_torch.recon.incremental.reconstruct`` at one seed.  The port's draw
sites (``ransac.gumbel_noise`` in its seed search and resection, the noise
of ``register_points_verified``) get the reference's Gumbel rows for the same
call: the reference's key splitting is mirrored over its power-of-two padded
batch counts and the rows of the real candidates are taken.  The port's
resection runs in one chunk a round, as the reference's does, so one call of
the port is one call of the reference.

Per round it prints, for each package, the registered cameras, the alive
landmarks, the landmarks past 30 m from the median of the alive ones (count
and ids), and across packages the largest camera-centre difference, the
cameras registered in one only and the alive landmarks in one only.

Run from the repository root (~3 min a package for a 128-frame session):
    JAX_PLATFORMS=cpu python3 tests/f15_lockstep.py save FILE.npz [frames [session]]
    JAX_PLATFORMS=cpu python3 tests/f15_lockstep.py run FILE.npz [seed]
    JAX_PLATFORMS=cpu python3 tests/f15_lockstep.py seeds FILE.npz [first-last]   # 0-15
    JAX_PLATFORMS=cpu python3 tests/f15_lockstep.py ba FILE.npz [seed [calls]]
    python3 tests/f15_lockstep.py fixture FILE.npz tests/f15_session2.npz
"""
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAR_M = 30.0


def save(path: str, fps: int = 128, session: int = 2) -> None:
    from sfmx_torch import run_configs as rc
    from sfmx_torch.cli.pipeline import build_front_end

    room = rc._examples()
    poses, spans, cfg, _q = rc.serve_inputs(fps)
    lo, hi = spans[session]
    imgs = rc._render_room(room.RoomTexture(seed=7), poses[lo:hi])
    intr = rc._intr()
    cam_k = np.zeros(len(imgs), np.int32)
    feats, pairs, res, _cnt, tt = build_front_end(imgs, intr, cam_k, cfg, "cpu")
    np.savez_compressed(
        path, kp_uv=feats.kp.uv.numpy(), kp_mask=feats.kp.mask.numpy(),
        obs_cam=tt.obs_cam, obs_feat=tt.obs_feat, obs_track=tt.obs_track,
        n_tracks=tt.n_tracks, intr=np.asarray(intr, np.float32), cam_k=cam_k,
        pairs=np.asarray(pairs), pair_counts=res.valid.sum(dim=1).numpy(),
        eyes=np.stack([eye for (_, _, eye) in poses[lo:hi]]).astype(np.float32))
    print(json.dumps({"saved": path, "cams": len(imgs), "tracks": int(tt.n_tracks),
                      "obs": int(len(tt.obs_cam)), "pairs": int(len(pairs))}))


def fixture(path: str, out: str) -> None:
    """A smaller copy of a saved session for a test: the keypoints that no
    track observes zeroed (``reconstruct`` reads only the tracks' own)."""
    d = load(path)
    used = np.zeros(d["kp_mask"].shape, bool)
    used[d["obs_cam"], d["obs_feat"]] = True
    d["kp_uv"] = np.where(used[..., None], d["kp_uv"], 0.0).astype(np.float32)
    np.savez_compressed(out, **d)
    print(json.dumps({"fixture": out, "bytes": Path(out).stat().st_size}))


def load(path: str) -> dict:
    d = dict(np.load(path))
    d["n_tracks"] = int(d["n_tracks"])
    return d


class JaxDraws:
    """The reference's draws in its order: ``key, sk = split(key)`` per call,
    ``split(sk, pow2(n))`` per candidate, ``gumbel(keys[i], (H, K))``."""

    def __init__(self, seed: int):
        import jax

        self.jax = jax
        self.key = jax.random.PRNGKey(seed)

    def rows(self, n: int, shape) -> np.ndarray:
        jax = self.jax
        n_pad = 1 << max(0, (n - 1).bit_length())
        self.key, sk = jax.random.split(self.key)
        keys = jax.random.split(sk, n_pad)[:n]
        return np.array(jax.vmap(lambda k: jax.random.gumbel(k, tuple(shape)))(keys))

    def sub_key(self):
        self.key, sk = self.jax.random.split(self.key)
        return sk


def far(X, alive) -> tuple[int, list]:
    ids = np.flatnonzero(alive)
    if len(ids) == 0:
        return 0, []
    d = np.linalg.norm(X[ids] - np.median(X[ids], 0), axis=1)
    return int((d > FAR_M).sum()), ids[d > FAR_M].tolist()


def centers(R, t):
    return -np.einsum("cji,cj->ci", R, t)


def run_reference(d: dict, seed: int, rounds_only: int | None = None) -> list:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import sfmx.recon.incremental as inc
    from sfmx.recon.incremental import ReconConfig
    from sfmx.recon.tracks import TrackTable
    from sfmx.solvers import lm

    return _run(inc, lm, ReconConfig(seed=seed), TrackTable, d, kw={}, rounds_only=rounds_only)


def run_port(d: dict, seed: int, draws: "JaxDraws | None",
             rounds_only: int | None = None) -> list:
    """The port's ``reconstruct``: on the reference's draws (``draws``) or,
    with None, on its own."""
    import torch

    import sfmx_torch.recon.incremental as inc
    from sfmx_torch.recon.incremental import ReconConfig
    from sfmx_torch.recon.tracks import TrackTable
    from sfmx_torch.solvers import lm

    if draws is None:
        return _run(inc, lm, ReconConfig(seed=seed), TrackTable, d, kw={"device": "cpu"},
                    rounds_only=rounds_only)
    inc._RESECT_CHUNK = 1 << 30            # one resection call a round, as the reference's

    def gumbel_noise(shape, *, device, generator=None):
        n, H, K = shape
        return torch.as_tensor(draws.rows(n, (H, K)), device=device)

    def jax_noise():
        sk = draws.sub_key()
        state = {"key": sk}

        def draw(shape):
            state["key"], k = draws.jax.random.split(state["key"])
            return np.asarray(draws.jax.random.gumbel(k, tuple(shape)))
        return draw

    reg_pv = inc.register_points_verified

    def register_points_verified(Pa, Pb, *, device, noise=None, **kw):
        return reg_pv(Pa, Pb, device=device, noise=jax_noise(), **kw)

    saved = (inc._RESECT_CHUNK, inc.ransac.gumbel_noise, inc.register_points_verified)
    inc.ransac.gumbel_noise = gumbel_noise
    inc.register_points_verified = register_points_verified
    try:
        return _run(inc, lm, ReconConfig(seed=seed), TrackTable, d, kw={"device": "cpu"},
                    rounds_only=rounds_only)
    finally:
        inc._RESECT_CHUNK, inc.ransac.gumbel_noise, inc.register_points_verified = saved


class _Stop(Exception):
    pass


def _run(inc, lm, cfg, TrackTable, d, kw, rounds_only: int | None = None) -> list:
    """Runs ``inc.reconstruct`` and records each round's state: the last BA's
    poses and points and the callback's registered / alive masks.  With
    ``rounds_only`` it stops after that many rounds (no final state)."""
    last = {}
    rounds = []
    solve = lm.ba_solve

    def ba_solve(*a, **k):
        out = solve(*a, **k)
        last["R"], last["t"], last["X"] = (np.array(x) for x in out[:3])
        return out

    def callback(registered, X_alive):
        rounds.append({"registered": registered, "alive": X_alive,
                       "R": last["R"].copy(), "t": last["t"].copy(), "X": last["X"].copy()})
        if rounds_only is not None and len(rounds) >= rounds_only:
            raise _Stop

    lm.ba_solve = ba_solve
    try:
        tt = TrackTable(d["obs_cam"], d["obs_feat"], d["obs_track"], d["n_tracks"])
        scene, stats = inc.reconstruct(d["kp_uv"], d["kp_mask"], tt, d["intr"], d["cam_k"], cfg,
                                       callbacks=callback,
                                       pair_counts=(d["pairs"], d["pair_counts"]), **kw)
    except _Stop:
        return rounds
    finally:
        lm.ba_solve = solve
    final = {"registered": np.asarray(scene.cam_alive).copy(),
             "alive": np.asarray(scene.X_alive).copy(), "R": np.array(scene.cam_R),
             "t": np.array(scene.cam_t), "X": np.array(scene.X), "final": True,
             "init_pair": stats.get("init_pair"), "components": stats.get("components")}
    return rounds + [final]


def compare(ref: list, port: list, out=print) -> int | None:
    """Prints each round side by side; returns the first round where the
    port keeps a far landmark alive that the reference has not kept alive,
    or where the registered sets differ (None if none)."""
    first = None
    for i in range(max(len(ref), len(port))):
        row = {"round": i}
        a = ref[i] if i < len(ref) else None
        b = port[i] if i < len(port) else None
        for name, s in (("ref", a), ("port", b)):
            if s is None:
                row[name] = None
                continue
            n_far, ids = far(s["X"], s["alive"])
            row[name] = {"registered": int(s["registered"].sum()), "alive": int(s["alive"].sum()),
                         "far": n_far, "far_ids": ids[:20]}
        if a is not None and b is not None:
            both = a["registered"] & b["registered"]
            dc = np.linalg.norm(centers(a["R"], a["t"])[both] - centers(b["R"], b["t"])[both],
                                axis=1)
            both_pts = a["alive"] & b["alive"]
            dx = np.linalg.norm(a["X"][both_pts] - b["X"][both_pts], axis=1)
            row["max_center_diff"] = float(dc.max()) if len(dc) else None
            row["max_point_diff"] = float(dx.max()) if len(dx) else None
            row["p99_point_diff"] = float(np.quantile(dx, 0.99)) if len(dx) else None
            row["cams_ref_only"] = np.flatnonzero(a["registered"] & ~b["registered"]).tolist()
            row["cams_port_only"] = np.flatnonzero(b["registered"] & ~a["registered"]).tolist()
            row["alive_ref_only"] = int((a["alive"] & ~b["alive"]).sum())
            row["alive_port_only"] = int((b["alive"] & ~a["alive"]).sum())
            _, far_port = far(b["X"], b["alive"])
            far_new = [t for t in far_port if not a["alive"][t]
                       or t not in far(a["X"], a["alive"])[1]]
            row["port_far_not_ref"] = far_new
            if first is None and (far_new or row["cams_ref_only"] or row["cams_port_only"]):
                first = i
        out(json.dumps(row))
    return first


def final_far(states: list) -> dict:
    s = states[-1]
    n, ids = far(s["X"], s["alive"])
    X = s["X"][s["alive"]]
    d = np.linalg.norm(X - np.median(X, 0), axis=1)
    return {"registered": int(s["registered"].sum()), "alive": int(s["alive"].sum()),
            "far": n, "far_ids": ids, "farthest_m": float(d.max())}


def seeds(d: dict, seed_list) -> None:
    """Per seed: the reference on its draws, the port on the reference's
    draws (the lockstep) and the port on its own draws; each one's final
    far landmarks, and whether the lockstep kept the reference's."""
    counts = {"reference": 0, "port_lockstep": 0, "port_own": 0}
    for seed in seed_list:
        ref = final_far(run_reference(d, seed))
        lock = final_far(run_port(d, seed, JaxDraws(seed)))
        own = final_far(run_port(d, seed, None))
        for k, v in (("reference", ref), ("port_lockstep", lock), ("port_own", own)):
            counts[k] += v["far"] > 0
        print(json.dumps({"seed": seed, "reference": ref, "port_lockstep": lock,
                          "port_own": own,
                          "lockstep_same_far": ref["far_ids"] == lock["far_ids"]}), flush=True)
    print(json.dumps({"seeds": len(seed_list), "builds_with_a_far_landmark": counts}))


def ba_stage(d: dict, seed: int, call: int = 0) -> dict:
    """The BA stage alone: the reference's ``call``-th ``lm.ba_solve`` of a
    build at ``seed`` (its alive rows plus the dead rows it pads with at
    weight 0) solved again by both packages, on the padded table and on the
    alive rows alone.  Returns the largest camera-centre and point
    differences between each pair of solves and their final costs."""
    import jax.numpy as jnp
    import torch

    from sfmx.solvers import lm as jlm
    from sfmx_torch.solvers import lm as tlm

    calls = []
    solve = jlm.ba_solve

    def record(*a, **k):
        if len(calls) <= call:
            calls.append(([np.array(x) for x in a], dict(k)))
        return solve(*a, **k)

    jlm.ba_solve = record
    try:
        run_reference(d, seed)
    finally:
        jlm.ba_solve = solve
    args, kw = calls[call]
    alive = args[8] > 0
    keep = lambda a: [x[alive] if i in (5, 6, 7, 8) else x for i, x in enumerate(a)]
    it = dict(iters=kw["iters"], cg_iters=kw["cg_iters"], huber_px=kw["huber_px"])

    def ref(a):
        R, t, X, c = jlm.ba_solve(*(jnp.asarray(x) for x in a), **it)
        return np.asarray(R), np.asarray(t), np.asarray(X), np.asarray(c)

    def port(a):
        T = [torch.as_tensor(np.ascontiguousarray(x)) for x in a]
        R, t, X, c = tlm.ba_solve(*T, **it)
        return R.numpy(), t.numpy(), X.numpy(), c.numpy()

    sols = {"ref_padded": ref(args), "ref_alive": ref(keep(args)),
            "port_padded": port(args), "port_alive": port(keep(args))}
    pts = np.unique(args[6][alive])
    cams = np.unique(args[5][alive])
    out = {"call": call, "rows": int(len(alive)), "alive_rows": int(alive.sum()),
           "iters": it["iters"], "costs": {k: [float(v[3][0]), float(v[3][-1])]
                                           for k, v in sols.items()}}
    names = list(sols)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            A, B = sols[a], sols[b]
            dc = np.linalg.norm(centers(A[0], A[1])[cams] - centers(B[0], B[1])[cams], axis=1)
            dx = np.linalg.norm(A[2][pts] - B[2][pts], axis=1)
            out[f"{a}~{b}"] = {"max_center": float(dc.max()),
                               "median_point": float(np.median(dx)),
                               "max_point": float(dx.max())}
    return out


def main() -> int:
    cmd, path = sys.argv[1], sys.argv[2]
    if cmd == "save":
        fps = int(sys.argv[3]) if len(sys.argv) > 3 else 128
        session = int(sys.argv[4]) if len(sys.argv) > 4 else 2
        save(path, fps, session)
        return 0
    if cmd == "fixture":
        fixture(path, sys.argv[3])
        return 0
    if cmd == "seeds":
        lo, hi = (int(x) for x in sys.argv[3].split("-")) if len(sys.argv) > 3 else (0, 15)
        seeds(load(path), range(lo, hi + 1))
        return 0
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    d = load(path)
    if cmd == "ba":
        for call in range(int(sys.argv[4]) if len(sys.argv) > 4 else 1):
            print(json.dumps(ba_stage(d, seed, call)), flush=True)
        return 0
    ref = run_reference(d, seed)
    port = run_port(d, seed, JaxDraws(seed))
    first = compare(ref, port)
    print(json.dumps({"first_parting_round": first,
                      "ref_final": {"init_pair": ref[-1]["init_pair"],
                                    "components": ref[-1]["components"]},
                      "port_final": {"init_pair": port[-1]["init_pair"],
                                     "components": port[-1]["components"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
