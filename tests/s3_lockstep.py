"""S3 and S4 (ROADMAP.md queue 3): the 96-frame walk's self-calibration, the
reference beside the port on the card's track table and on the same draws.

The table and the joint LM's starting state come from the card
(``chip_experiments/selfcal_state.py --capture``: ``selfcal_walk.npz`` and
``selfcal_card_state.npz``).  Every build here runs ``reconstruct`` with
``refine_intrinsics=("f",)`` on the CPU.  "lock" is the port on the
reference's RANSAC draws (``f15_lockstep.run_port``: the reference's key
splitting over its power-of-two padded counts mirrored into the port's draw
sites), "own" the port on its own draws, "ref_eager" the reference evaluated
eagerly (``jax.disable_jit``: its measure of how far it parts from itself).

    seeds NPZ [first-last [ref,lock,own,ref_eager]]   per seed and package: the seed pair,
                                            its trial score and rank, inliers,
                                            parallax, init_med_px, the refined
                                            focal, the joint LM's non-finite
                                            trials; then the rate of builds
                                            more than 3 % off
    pair NPZ A B [seed]                     the seed pair forced to (A, B) in
                                            both packages, on the reference's
                                            draws: cameras registered round by
                                            round, the refined focal, the joint
                                            LM's cost trace
    state STATE_NPZ                         the joint LM from one state: the
                                            reference compiled and evaluated
                                            eagerly, the port; each one's cost
                                            trace, its non-finite trials and at
                                            each of them the CG's smallest pAp,
                                            its rz and the smallest camera pivot
    record NPZ first-last DIR               "lock" with its minimal samples saved
                                            in call order, for the card to replay
                                            (``selfcal_state.py --replay DIR``)
    fixture NPZ STATE_NPZ OUT               the pin's fixture: the table with the
                                            keypoints no track observes zeroed,
                                            and the state, compressed

Run from the repository root (~25 s a build):
    JAX_PLATFORMS=cpu python3 tests/s3_lockstep.py seeds .chip_scratch/selfcal_walk.npz 0-23
"""
import contextlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "chip_experiments"))

from tests import f15_lockstep as ls  # noqa: E402

import selfcal_state as sc  # noqa: E402

CFG_KW = {"refine_intrinsics": ("f",)}


@contextlib.contextmanager
def hooks(inc, lm, order, force=None):
    """While the block runs: the first seed search's inlier counts and
    parallaxes recorded (the primary component's), with ``force`` = (a, b)
    every other candidate's count set to 0 there, so that only (a, b) passes
    the gate (the candidates, and so the draws, are those of the unforced
    search); and the joint LM's cost trace recorded."""
    got = {}
    batch, joint = inc._init_pair_batch, lm.ba_solve_intrinsics

    def init_pair_batch(*a, **k):
        out = batch(*a, **k)
        if "cnt" in got:
            return out
        cnt = out[3]
        if force is not None:
            keep = np.arange(cnt.shape[0]) == order.index(tuple(force))
            if hasattr(cnt, "cpu"):
                import torch

                cnt = torch.where(torch.as_tensor(keep, device=cnt.device), cnt,
                                  torch.zeros_like(cnt))
            else:
                import jax.numpy as jnp

                cnt = jnp.where(jnp.asarray(keep), cnt, 0)
            out = (*out[:3], cnt, *out[4:])
        got["cnt"] = np.asarray(cnt.cpu() if hasattr(cnt, "cpu") else cnt)[:len(order)]
        got["par"] = np.asarray(out[4].cpu() if hasattr(out[4], "cpu") else out[4])[:len(order)]
        return out

    def ba_solve_intrinsics(*a, **k):
        out = joint(*a, **k)
        got["costs"] = np.asarray(out[4].cpu() if hasattr(out[4], "cpu") else out[4])
        return out

    inc._init_pair_batch, lm.ba_solve_intrinsics = init_pair_batch, ba_solve_intrinsics
    try:
        yield got
    finally:
        inc._init_pair_batch, lm.ba_solve_intrinsics = batch, joint


def _modules(pkg: str):
    if pkg == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import sfmx.recon.incremental as inc
        from sfmx.solvers import lm
    else:
        import sfmx_torch.recon.incremental as inc
        from sfmx_torch.solvers import lm
    return inc, lm


def build(d: dict, seed: int, pkg: str, force=None, rounds_only=None) -> tuple[dict, list]:
    """One ``reconstruct`` of ``pkg`` ("ref", "lock" or "own") at ``seed``:
    (a summary, the rounds of ``f15_lockstep._run``)."""
    from sfmx_torch.recon.incremental import ReconConfig

    inc, lm = _modules("ref" if pkg.startswith("ref") else "port")
    cfg = ReconConfig(seed=seed, **CFG_KW)
    order = sc.pair_order(d["pairs"], d["pair_counts"], cfg.min_init_inliers)
    with hooks(inc, lm, order, force) as got:
        if pkg == "ref":
            rounds = ls.run_reference(d, seed, rounds_only=rounds_only, cfg_kw=CFG_KW)
        elif pkg == "ref_eager":          # the reference against itself
            import jax

            with jax.disable_jit():
                rounds = ls.run_reference(d, seed, rounds_only=rounds_only, cfg_kw=CFG_KW)
        else:
            draws = ls.JaxDraws(seed) if pkg == "lock" else None
            rounds = ls.run_port(d, seed, draws, rounds_only=rounds_only, cfg_kw=CFG_KW)
    out = {"seed": seed, "pkg": pkg}
    score = sc.trial_scores(order, got["cnt"], got["par"], d["kp_uv"].shape[0], cfg)
    ranked = [order[i] for i in np.argsort(-score, kind="stable") if score[i] > 0]
    final = rounds[-1]
    if not final.get("final"):
        return out, rounds
    st = final["stats"]
    a, b = (int(c) for c in st["init_pair"])
    ci = order.index((a, b))
    f = float(np.asarray(st["refined_intrinsics"])[0][0])
    c = sc.cost_summary(got["costs"])
    out.update({"init_pair": [a, b], "trial_rank": ranked.index((a, b)),
                "trial_score": float(score[ci]), "inliers": int(got["cnt"][ci]),
                "parallax_deg": float(got["par"][ci]), "init_med_px": st["init_pairs"][0][2],
                "focal": f, "rel": f / sc.FOCAL_TRUE - 1.0,
                "miss": abs(f / sc.FOCAL_TRUE - 1.0) > sc.MISS,
                "registered": int(final["registered"].sum()), "rounds": len(rounds) - 1,
                "costs": c["costs"], "non_finite": c["non_finite"],
                "non_finite_at": c["non_finite_at"]})
    return out, rounds


def seeds(d: dict, seed_list, pkgs) -> None:
    rows = {p: [] for p in pkgs}
    for seed in seed_list:
        for p in pkgs:
            row, _ = build(d, seed, p)
            rows[p].append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "costs"}), flush=True)
    print(json.dumps({"seeds": len(seed_list), **{
        p: {"misses_over_3pct": sum(r["miss"] for r in rs),
            "miss_seeds": [r["seed"] for r in rs if r["miss"]],
            "focal_min": min(r["focal"] for r in rs), "focal_max": max(r["focal"] for r in rs),
            "pairs_6_93": sum(r["init_pair"] == [6, 93] for r in rs),
            "non_finite_builds": sum(r["non_finite"] > 0 for r in rs)} for p, rs in rows.items()}}))


def pair(d: dict, a: int, b: int, seed: int) -> None:
    """Both packages from the forced seed pair (a, b), on the reference's draws."""
    res = {}
    for p in ("ref", "lock"):
        res[p] = build(d, seed, p, force=(a, b))
        print(json.dumps(res[p][0]), flush=True)
    ra, rb = res["ref"][1], res["lock"][1]
    for i in range(max(len(ra), len(rb))):
        row = {"round": i}
        for name, rr in (("ref", ra), ("lock", rb)):
            row[name] = int(rr[i]["registered"].sum()) if i < len(rr) else None
        if i < len(ra) and i < len(rb):
            x, y = ra[i], rb[i]
            row["cams_ref_only"] = np.flatnonzero(x["registered"] & ~y["registered"]).tolist()
            row["cams_lock_only"] = np.flatnonzero(y["registered"] & ~x["registered"]).tolist()
            both = x["registered"] & y["registered"]
            dc = np.linalg.norm(ls.centers(x["R"], x["t"])[both] - ls.centers(y["R"], y["t"])[both],
                                axis=1)
            row["max_center_diff"] = float(dc.max()) if len(dc) else None
        print(json.dumps(row), flush=True)


def record(d: dict, seed_list, out_dir) -> None:
    """The port on the reference's draws ("lock") with every minimal sample
    it draws recorded in call order (``ransac.sample_minimal``'s indices):
    ``OUT_DIR/samples_seed<seed>.npz``, which
    ``chip_experiments/selfcal_state.py --replay`` feeds the port on the
    card, so the card runs on the reference's draws without jax."""
    from sfmx_torch.solvers import ransac

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    orig = ransac.sample_minimal
    for seed in seed_list:
        calls = []

        def sample_minimal(gumbel, mask, sample_size):
            idx = orig(gumbel, mask, sample_size)
            calls.append(idx.cpu().numpy().astype(np.int16))
            return idx

        ransac.sample_minimal = sample_minimal
        try:
            row, _ = build(d, seed, "lock")
        finally:
            ransac.sample_minimal = orig
        np.savez_compressed(out_dir / f"samples_seed{seed}.npz",
                            **{f"call{i:03d}": c for i, c in enumerate(calls)},
                            init_pair=np.asarray(row["init_pair"]), focal=row["focal"])
        print(json.dumps({"recorded": seed, "calls": [list(c.shape) for c in calls],
                          **{k: v for k, v in row.items() if k != "costs"}}), flush=True)


def ref_joint_trace(state: dict, eager: bool) -> dict:
    """The reference's ``ba_solve_intrinsics`` (``selfcal_state.KW``) from
    ``state``: compiled, or evaluated eagerly (``jax.disable_jit``: its scan
    a Python loop) with each PCG step's ``rz`` and ``pAp`` and the camera
    pivot recorded (``pcg_k``'s loop written out with the records)."""
    import jax
    import jax.numpy as jnp

    from sfmx.solvers import lm as jlm
    from sfmx.solvers import schur as js

    args = [jnp.asarray(state[n]) for n in sc.NAMES]
    if not eager:
        _R, _t, _X, intr, costs = jlm.ba_solve_intrinsics(*args, **sc.KW)
        f = float(intr[0, 0])
        return {"device": "cpu", "mode": "compiled", "focal": f, "rel": f / sc.FOCAL_TRUE - 1.0,
                **sc.cost_summary(np.asarray(costs))}
    rec = {"rz": [], "pAp": [], "pivot": []}
    fixed = np.asarray(state["fixed"], bool)
    orig = js.pcg_k

    def pcg_k(sk, iters=30, fixed_cam_mask=None, pt_sorted=False):
        import torch

        rec["pivot"].append(sc.min_pivot(torch.as_tensor(np.array(sk.sys.Ud)), fixed))
        Minv_c, Minv_k = js._inv_spd(sk.sys.Ud), js._inv_spd(sk.Ukk_d)

        def proj(xc, xk):
            return jnp.where(fixed_cam_mask[:, None], 0.0, xc), xk

        def prec(rc, rk):
            return (jnp.einsum("cij,cj->ci", Minv_c, rc), jnp.einsum("gij,gj->gi", Minv_k, rk))

        def dot(a, b):
            return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

        b_c, b_k = proj(sk.sys.b_red, sk.b_red_k)
        x = (jnp.zeros_like(b_c), jnp.zeros_like(b_k))
        r = (b_c, b_k)
        z = proj(*prec(*r))
        p = z
        rzs, paps = [], []
        for _ in range(iters):
            Sp = proj(*js.schur_matvec_k(sk, *p, pt_sorted=pt_sorted))
            rz = dot(r, z)
            pAp = dot(p, Sp)
            rzs.append(float(rz))
            paps.append(float(pAp))
            alpha = rz / jnp.maximum(pAp, 1e-20)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            r = (r[0] - alpha * Sp[0], r[1] - alpha * Sp[1])
            z = proj(*prec(*r))
            beta = dot(r, z) / jnp.maximum(rz, 1e-20)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
        rec["rz"].append(rzs)
        rec["pAp"].append(paps)
        return x[0], x[1]

    js.pcg_k = pcg_k
    try:
        with jax.disable_jit():
            _R, _t, _X, intr, costs = jlm.ba_solve_intrinsics(*args, **sc.KW)
    finally:
        js.pcg_k = orig
    f = float(intr[0, 0])
    c = np.asarray(costs)
    # the cost entry i + 1 is iteration i's best trial: NaN there means the
    # step itself was not finite (argmin takes a NaN first)
    rec["trials"] = [[float(v)] for v in c[1:]]
    return {"device": "cpu", "mode": "eager", "focal": f, "rel": f / sc.FOCAL_TRUE - 1.0,
            **sc.cost_summary(c), **rec}


def state_cmd(path) -> None:
    st = dict(np.load(path))
    print(json.dumps({"state": str(path), "observations": int(len(st["cam_id"])),
                      "focal_in": float(st["intr"][0, 0])}), flush=True)
    print(json.dumps({"pkg": "ref", **ref_joint_trace(st, eager=False)}), flush=True)
    tr = ref_joint_trace(st, eager=True)
    print(json.dumps({"pkg": "ref", "mode": "eager", **sc.trace_brief(tr)}), flush=True)
    tr = sc.joint_trace(st, "cpu")
    print(json.dumps({"pkg": "port", **sc.trace_brief(tr)}), flush=True)


def fixture(walk, state, out) -> None:
    """The walk's table with the keypoints no track observes zeroed
    (``reconstruct`` reads only the tracks' own) and the card's joint-LM
    state under ``state_`` names, in one compressed file."""
    d = ls.load(walk)
    used = np.zeros(d["kp_mask"].shape, bool)
    used[d["obs_cam"], d["obs_feat"]] = True
    d["kp_uv"] = np.where(used[..., None], d["kp_uv"], 0.0).astype(np.float32)
    d.update({f"state_{k}": v for k, v in np.load(state).items()})
    np.savez_compressed(out, **d)
    print(json.dumps({"fixture": str(out), "bytes": Path(out).stat().st_size}))


def main() -> int:
    cmd = sys.argv[1]
    if cmd == "state":
        state_cmd(sys.argv[2])
        return 0
    if cmd == "fixture":
        fixture(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    d = ls.load(sys.argv[2])
    if cmd == "seeds":
        lo, hi = (int(x) for x in sys.argv[3].split("-")) if len(sys.argv) > 3 else (0, 23)
        pkgs = sys.argv[4].split(",") if len(sys.argv) > 4 else ["ref", "lock", "own"]
        seeds(d, range(lo, hi + 1), pkgs)
    elif cmd == "record":
        lo, hi = (int(x) for x in sys.argv[3].split("-"))
        record(d, range(lo, hi + 1), sys.argv[4])
    elif cmd == "pair":
        pair(d, int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]) if len(sys.argv) > 5 else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
