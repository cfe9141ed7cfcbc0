"""The port's evaluation-config harness (``sfmx_torch.run_configs``) against
``bench/run_configs.py``.

The reference module parses ``sys.argv`` when it is imported, so it is
loaded through importlib with ``sys.argv`` patched and
``SFMX_JAX_CACHE=off`` (it writes no compile cache), and each case sets
the fields of its ``args``.

Input parity at the reference's own sizes: each reference config runs with
its entry point patched to record its arguments and raise (renderers
stubbed where only the poses matter), the port's config the same way, and
the records are compared array for array and field for field.  Then small
runs on the CPU against the reference: config 3's final cost within 1e-4
relative of ``sfmx.solvers.lm.ba_solve`` on the same small problem (both
solve the same planes system in f32 for 5 iterations); config 4 at world
size 2 (gloo ranks) against ``sfmx.dist.block_ba`` on a 2-device sub-mesh,
the layout stats exact and the final cost within 1e-3 relative (the
tolerance of ``test_torch_block_ba``: collectives and fixed-order segment
sums add in another order); config 5 (both merged ATEs < 0.1 m, equal
camera counts); ``block_ba_real_scene`` on a scene the port built (the
reference's layout stats exactly, ranks bit-identical, the cost monotone,
world sizes 1 and 2 within 5 %, the reference's blocked solve within
1e-3); config 1 beside the reference's (both demos pass; registered
cameras equal, the ATEs and query errors under the demo's gates);
config 2 at 8 frames beside the reference's ``config2`` run at 8 frames
(its walk length is a literal 32, so the test compiles the function with
that literal set to 8): registered cameras equal, each ATE under 0.1 m and
within 0.01 m of the other, median inliers within 10 %, and the inputs of
``build_localization_map`` and of every ``localize_query`` held to each
package's own build (the build's features and track table, frame i's
rows, the intrinsics, the RANSAC key or generator seeded with i).
Failure paths: each config's JSON keys are the reference's (read from its
source) plus ``device``, the HTTP serving and PNG frame files raise
without their packages, the PNG files decode to the frames' 8 bits, and
the harness imports neither jax nor sfmx.
"""
import ast
import contextlib
import dataclasses
import io
import re
import importlib.util
import json
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.room
import sfmx.cli.main as rclimain
import sfmx.cli.pipeline as rpipe
import sfmx.dist.block_ba as rblock_ba
import sfmx.dist.block_layout as rlayout
import sfmx.kernels.matching as rmatching
import sfmx.localize as rlocalize
import sfmx.recon.merge as rmerge
import sfmx.solvers.lm as rlm
import sfmx_torch.cli.main as tclimain
import sfmx_torch.cli.pipeline as tpipe
import sfmx_torch.dist.block_ba as tblock_ba
import sfmx_torch.dist.block_layout as tlayout
import sfmx_torch.kernels.matching as tmatching
import sfmx_torch.localize as tlocalize
import sfmx_torch.recon.incremental as tinc
import sfmx_torch.recon.merge as tmerge
import sfmx_torch.solvers.lm as tlm
import tests.test_merge as rtest_merge
from sfmx.dist import mesh as rmesh
from sfmx_torch import run_configs as rc

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


class _Stop(Exception):
    """Raised by a recording entry: the inputs are all the test needs."""


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _same_config(ref, port):
    """Equal in every field both dataclasses have."""
    def diff(a, b, path=""):
        out = []
        for k in a.keys() & b.keys():
            if isinstance(a[k], dict) and isinstance(b[k], dict):
                out += diff(a[k], b[k], f"{path}{k}.")
            elif a[k] != b[k]:
                out.append((path + k, a[k], b[k]))
        return out

    assert diff(dataclasses.asdict(ref), dataclasses.asdict(port)) == []


def _recorder(calls, result=None):
    def rec(*a, **k):
        calls.append((a, k))
        if result is None:
            raise _Stop
        return result
    return rec


def _passthrough(calls, fn):
    def rec(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)
    return rec


def _passthrough_out(calls, fn):
    """Records (args, kwargs, result)."""
    def rec(*a, **k):
        out = fn(*a, **k)
        calls.append((a, k, out))
        return out
    return rec


@pytest.fixture(scope="module")
def ref():
    """``bench/run_configs.py`` as a module (its argv parsed as config 1)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["run_configs.py", "--config", "1"])
        m.setenv("SFMX_JAX_CACHE", "off")
        spec = importlib.util.spec_from_file_location("reference_run_configs",
                                                      ROOT / "bench" / "run_configs.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _with_args(ref, m, **fields):
    for k, v in fields.items():
        m.setattr(ref.args, k, v)


def _run_until_stop(patches, fn, *args, **kw):
    with pytest.MonkeyPatch.context() as m:
        for obj, name, value in patches:
            m.setattr(obj, name, value)
        with pytest.raises(_Stop):
            fn(*args, **kw)


# ---------------------------------------------------------------------------
# Input parity at the reference's sizes
# ---------------------------------------------------------------------------


def test_synthetic_ba_is_the_reference(ref):
    for a, b in zip(ref._synthetic_ba(512, 20000, 200000), rc._synthetic_ba(512, 20000, 200000)):
        _same(a, b)


def test_config3_inputs(ref):
    """``lm.ba_solve``'s arguments: the same 512 / 20,000 / 200,000 problem,
    unit weights, camera 0 fixed, 20 LM iterations x 30 CG steps."""
    rb, pb = [], []
    _run_until_stop([(rlm, "ba_solve", _recorder(rb))], ref.config3)
    _run_until_stop([(tlm, "ba_solve", _recorder(pb))], rc.config3, "cpu")
    (ra, rk), (pa, pk) = rb[0], pb[0]
    assert len(ra) == len(pa) == 10 and rk == pk == {"iters": 20, "cg_iters": 30}
    for a, b in zip(ra, pa):
        _same(a, b)


def test_config4_problem_and_step_inputs(ref, tmp_path):
    """Config 4 on 8 blocks (the reference's 8 virtual devices): the
    corridor problem, the layout's inputs, the scatters and every argument
    of the block step bit-equal; the step's iterations and CG steps."""
    n = len(jax.devices())
    r_layout, r_cams, r_pts, r_mk, r_step = [], [], [], [], []

    def r_make(*a, **k):
        r_mk.append(k)
        return _recorder(r_step)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(rlayout, "build_block_layout",
                  _passthrough(r_layout, rlayout.build_block_layout))
        m.setattr(rlayout, "scatter_cams", _passthrough(r_cams, rlayout.scatter_cams))
        m.setattr(rlayout, "scatter_pts", _passthrough(r_pts, rlayout.scatter_pts))
        m.setattr(rblock_ba, "make_block_ba_step", r_make)
        with pytest.raises(_Stop):
            ref.config4()
    p_layout, p_mk, p_step = [], [], []

    def p_make(*a, **k):
        p_mk.append(k)
        return _recorder(p_step)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tlayout, "build_block_layout",
                  _passthrough(p_layout, tlayout.build_block_layout))
        m.setattr(tblock_ba, "make_block_ba_step", p_make)
        with pytest.raises(_Stop):
            rc._config4_rank(0, n, torch.device("cpu"), str(tmp_path), {},
                             rc.CONFIG4["iters"], rc.CONFIG4["cg_iters"])
    (ra, _), (pa, _) = r_layout[0], p_layout[0]
    assert len(ra) == len(pa) == 7 and ra[4:] == pa[4:] == (2048, 200_000, n)
    for a, b in zip(ra[:4], pa[:4]):
        _same(a, b)
    prob = rc.config4_problem(np.random.default_rng(1))
    for i, k in ((1, 1), (2, 2), (3, 3), (4, 9)):        # k_idx, R, t, fixed
        _same(r_cams[0][0][i], prob[k])
    _same(r_pts[0][0][1], prob[4])
    assert {k: r_mk[0][k] for k in ("n_blocks", "hcap", "iters", "cg_iters")} == \
        {k: p_mk[0][k] for k in ("n_blocks", "hcap", "iters", "cg_iters")} == \
        {"n_blocks": n, "hcap": r_mk[0]["hcap"], "iters": 8, "cg_iters": 25}
    (rs, _), (ps, _) = r_step[0], p_step[0]
    assert len(rs) == len(ps) == 13
    assert np.float32(ps[1]) == np.asarray(rs[1])        # the first damping, 1e-4 in f32
    for i, (a, b) in enumerate(zip(rs, ps)):
        if i != 1:
            _same(a, b)


def test_config2_build_inputs(ref):
    """Config 2's ``build_map`` arguments: the 32 rendered frames, the
    intrinsics, the camera indices, the pipeline config."""
    rb, pb = [], []
    with pytest.MonkeyPatch.context() as m:
        _with_args(ref, m, frames=32)
        _run_until_stop([(rpipe, "build_map", _recorder(rb))], ref.config2)
    _run_until_stop([(tpipe, "build_map", _recorder(pb))], rc.config2, "cpu")
    (ra, _), (pa, _) = rb[0], pb[0]
    for a, b in zip(ra[:3], pa[:3]):
        _same(a, b)
    _same_config(ra[3], pa[3])
    assert pa[4] == torch.device("cpu")


def _tmp_root(argv):
    return str(Path(argv[1]).parent)


def _blank_frames(*a, **k):
    return np.zeros((240, 320), np.float32)


@pytest.mark.parametrize("scene", ["room", "corridor"])
@pytest.mark.parametrize("frames", [64, 512, 1024])
def test_config2_scale_argv(ref, scene, frames, tmp_path, tmp_path_factory):
    """``build-map --stream``'s command line: the reference's overrides,
    window formula and final BA iterations at each walk length, plus the
    device; the frames stubbed blank (only the command line is held), the
    reference's own directory (``mkdtemp``, never removed) under the test's."""
    rb, pb = [], []
    with pytest.MonkeyPatch.context() as m:
        _with_args(ref, m, frames=frames, scene=scene, seed=3, final_ba_iters=0, rooms=4)
        m.setattr(tempfile, "mkdtemp", lambda prefix="": str(tmp_path_factory.mktemp(prefix)))
        for name in ("render_room", "render_corridor"):
            m.setattr(examples.room, name, _blank_frames)
        m.setattr(examples.room, "render_walk_parallel", lambda *a, **k: None)
        _run_until_stop([(rclimain, "main", _recorder(rb))], ref.config2_scale, frames)
        _run_until_stop([(tclimain, "main", _recorder(pb))], rc.config2_scale, "cpu",
                        tmp_path / "c2", frames=frames, scene=scene, seed=3, rooms=4)
    r_argv, p_argv = rb[0][0][0], pb[0][0][0]
    norm = lambda argv: [a.replace(_tmp_root(argv), "<tmp>") for a in argv]  # noqa: E731
    assert norm(p_argv) == norm(r_argv) + ["--device", "cpu"]
    assert f"match.window={rc.window_for(frames, scene, 4)}" in p_argv


def test_config5_session_inputs(ref):
    """Config 5's three sessions: the matcher's descriptors, masks and
    pairs, and ``reconstruct``'s keypoints, masks, track table, intrinsics,
    camera indices and config; ``merge_scenes`` gets the three."""
    r_match, r_rec, r_merge = [], [], []
    p_match, p_rec, p_merge = [], [], []
    dummy = (None, None)
    _run_until_stop([(rmatching, "match_pairs_float",
                      _passthrough(r_match, rmatching.match_pairs_float)),
                     (rtest_merge, "reconstruct", _recorder(r_rec, dummy)),
                     (rmerge, "merge_scenes", _recorder(r_merge))], ref.config5)
    _run_until_stop([(tmatching, "match_pairs_float_auto",
                      _passthrough(p_match, tmatching.match_pairs_float_auto)),
                     (tinc, "reconstruct", _recorder(p_rec, dummy)),
                     (tmerge, "merge_scenes", _recorder(p_merge))], rc.config5, "cpu")
    assert len(r_match) == len(p_match) == len(r_rec) == len(p_rec) == 3
    for (ra, _), (pa, _) in zip(r_match, p_match):
        for a, b in zip(ra, pa):
            _same(a, b)
    for (ra, _), (pa, pk) in zip(r_rec, p_rec):
        for a, b in zip(ra[:2], pa[:2]):
            _same(a, b)
        for k in ("obs_cam", "obs_feat", "obs_track"):
            _same(getattr(ra[2], k), getattr(pa[2], k))
        assert ra[2].n_tracks == pa[2].n_tracks
        _same(ra[3], pa[3])
        _same(ra[4], pa[4])
        _same_config(ra[5], pa[5])
        assert pk == {"device": torch.device("cpu")}
    assert len(r_merge[0][0][0]) == len(p_merge[0][0][0]) == 3


@pytest.mark.parametrize("fps", [48, 128])
def test_config5_serve_spans_and_configs(ref, fps):
    """``config5_serve``'s sessions: the poses each session renders (its
    span of the walk), ``build_map``'s intrinsics, camera indices and
    pipeline config (window pairs, ``max(8, fps // 6)``); frames stubbed."""
    def record_render(calls):
        def render(tex, R, eye, *a, **k):
            calls.append((R, eye, a))
            return _blank_frames()
        return render

    def dummy_build(calls):
        def build(images, intr, cam_k, cfg, *a, **k):
            calls.append((images.shape, intr, cam_k, cfg))
            n = len(cam_k)
            feats = types.SimpleNamespace(
                desc=torch.zeros((n, 1, 128)),
                kp=types.SimpleNamespace(uv=torch.zeros((n, 1, 2)),
                                         mask=torch.zeros((n, 1), dtype=torch.bool)))
            return None, feats, types.SimpleNamespace(obs_feat=np.zeros(0, np.int32)), {}
        return build

    r_render, r_build, p_render, p_build = [], [], [], []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(examples.room, "render_room", record_render(r_render))
        _run_until_stop([(rpipe, "build_map", dummy_build(r_build)),
                         (rmerge, "merge_scenes", _recorder([]))], ref.config5_serve, fps)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(examples.room, "render_room", record_render(p_render))
        _run_until_stop([(tpipe, "build_map", dummy_build(p_build)),
                         (tmerge, "merge_scenes", _recorder([]))], rc.config5_serve, "cpu",
                        fps=fps)
    assert len(r_render) == len(p_render) == sum(len(c) for _s, _i, c, _f in r_build)
    for (Ra, ea, aa), (Rb, eb, ab) in zip(r_render, p_render):
        _same(Ra, Rb)
        _same(ea, eb)
        assert aa == ab == (320, 240, 280.0)
    assert len(r_build) == len(p_build) == 3
    for (rs, ri, rk, rcfg), (ps, pi, pk, pcfg) in zip(r_build, p_build):
        assert rs == ps
        _same(ri, pi)
        _same(rk, pk)
        _same_config(rcfg, pcfg)
    assert p_build[0][3].match.window == max(8, fps // 6)


# ---------------------------------------------------------------------------
# Small runs against the reference
# ---------------------------------------------------------------------------

SMALL4 = dict(C=64, P=4000, obs_per_cam=100)


def test_config3_small_matches_reference():
    C, P, O, iters, cg = 16, 400, 4000, 5, 10
    line = rc.config3("cpu", C=C, P=P, O=O, iters=iters, cg_iters=cg)
    intr, R, t, X, cam_id, pt_id, uv = rc._synthetic_ba(C, P, O)
    fixed = jnp.zeros(C, bool).at[0].set(True)
    out = rlm.ba_solve(jnp.asarray(intr), jnp.zeros(C, jnp.int32), jnp.asarray(R),
                       jnp.asarray(t), jnp.asarray(X), jnp.asarray(cam_id), jnp.asarray(pt_id),
                       jnp.asarray(uv), jnp.ones(O, jnp.float32), fixed, iters=iters,
                       cg_iters=cg)
    np.testing.assert_allclose(line["final_cost"], float(out[3][-1]), rtol=1e-4)
    assert line["lm_iters_per_s"] > 0 and (line["cams"], line["points"], line["obs"]) == (C, P, O)


@pytest.fixture(scope="module")
def config4_small():
    return rc.config4("cpu", world_size=2, sizes=SMALL4, iters=3, cg_iters=10)


def test_config4_world_of_two_matches_reference(config4_small):
    """Two gloo ranks against the reference's block step on two devices."""
    line, ranks = config4_small
    assert len(ranks) == 2 and ranks[0]["digest"] == ranks[1]["digest"]
    intr, k_idx, R, t, X, cam_id, pt_id, uv, w, fixed = rc.config4_problem(
        np.random.default_rng(1), **SMALL4)
    C, P = R.shape[0], X.shape[0]
    layout = rlayout.build_block_layout(cam_id, pt_id, uv, w, C, P, 2)
    assert {k: line[k] for k in layout.stats()} == layout.stats()
    k_l, R_l, t_l, fixed_l = rlayout.scatter_cams(layout, k_idx, R, t, fixed)
    (X_l,) = rlayout.scatter_pts(layout, X)
    mesh2 = rmesh.make_mesh(rblock_ba.AXIS, jax.devices()[:2])
    step = rblock_ba.make_block_ba_step(mesh2, n_blocks=2, hcap=layout.hcap, iters=3,
                                        cg_iters=10)
    out = step(jnp.asarray(intr), jnp.asarray(1e-4, jnp.float32), jnp.asarray(k_l),
               jnp.asarray(R_l), jnp.asarray(t_l), jnp.asarray(X_l),
               jnp.asarray(fixed_l | (layout.cam_global < 0)), jnp.asarray(layout.obs_cam_l),
               jnp.asarray(layout.obs_pt_ext), jnp.asarray(layout.obs_uv),
               jnp.asarray(layout.obs_w), jnp.asarray(layout.halo_idx),
               jnp.asarray(layout.halo_mask))
    np.testing.assert_allclose(line["final_cost"], float(out[3][-1]), rtol=1e-3)
    assert (line["cams"], line["points"], line["obs"], line["devices"]) == (C, P, C * 100, 2)


def test_config5_matches_reference(ref):
    port, reference = rc.config5("cpu"), ref.config5()
    assert port["cams"] == reference["cams"]
    assert port["ate_m"] < 0.1 and reference["ate_m"] < 0.1


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Config 4-build at 12 room frames (PNG files), two gloo ranks."""
    return rc.config4_build("cpu", tmp_path_factory.mktemp("c4b"), frames=12, world_size=2)


def test_block_ba_real_scene_on_a_built_scene(built):
    line, ranks = built
    bb = line["block_ba"]
    assert line["pass"] and line["n_registered"] == 12 and bb["cost_monotone_ok"]
    assert len(ranks) == 2 and ranks[0]["digest"] == ranks[1]["digest"]
    args, n_cams = rc.real_scene_problem(bb["map"])
    C, P = args[2].shape[0], args[4].shape[0]
    layout = rlayout.build_block_layout(args[5], args[6], args[7], args[8], C, P, 2)
    assert {k: bb[k] for k in layout.stats()} == layout.stats()
    assert (bb["n_cams"], bb["n_pts"], bb["n_obs"]) == (n_cams, P, len(args[5]))
    mesh2 = rmesh.make_mesh(rblock_ba.AXIS, jax.devices()[:2])
    *_, costs, _ = rblock_ba.ba_solve_blocked(*args, mesh2, iters=4, cg_iters=15)
    np.testing.assert_allclose(bb["cost_final"], float(np.asarray(costs)[-1]), rtol=1e-3)
    one, ranks1 = rc.block_ba_real_scene(bb["map"], "cpu", world_size=1)
    assert one["n_blocks"] == 1 and one["cost_monotone_ok"] and len(ranks1) == 1
    assert abs(one["cost_final"] - bb["cost_final"]) <= 0.05 * one["cost_final"]


def _demo_numbers(out: str) -> dict:
    """The demo's printed registered cameras, ATE and held-out queries."""
    reg = re.search(r"\[recon\] registered (\d+)/(\d+)", out)
    ate = re.search(r"\[evaluate\].*'ate_rmse': ([-+0-9.e]+)", out)
    queries = re.findall(r"\[localize\] query \d+: inliers=(\d+) .*pos_err=([0-9.]+)m", out)
    return {"registered": int(reg.group(1)), "cams": int(reg.group(2)),
            "ate_m": float(ate.group(1)), "inliers": [int(q[0]) for q in queries],
            "pos_err_m": [float(q[1]) for q in queries], "pass": "DEMO: PASS" in out}


@pytest.fixture(scope="module")
def config1_both(ref, tmp_path_factory):
    """Config 1 through the port's command line and the reference's
    ``config1`` (``examples.demo_pipeline.main``, which parses its argv at
    import and saves its scene under a fixed /tmp path: here under a
    test directory).  Returns (the port's line, the port's demo output,
    the reference's line, its demo output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = rc.main(["--config", "1", "--device", "cpu"])
    port_out = buf.getvalue()
    store = tmp_path_factory.mktemp("demo") / "demo_scene.npz"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", ["demo_pipeline.py"])
        import examples.demo_pipeline as demo

        m.setattr(demo, "save_scene", lambda _path, scene, f=demo.save_scene: f(str(store), scene))
        m.setattr(demo, "load_scene", lambda _path, f=demo.load_scene: f(str(store)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref_line = ref.config1()
    return line, port_out, ref_line, buf.getvalue()


def test_config1_demo_passes(config1_both):
    line, port_out, _, _ = config1_both
    assert line["pass"] and line["device"]["name"] == "cpu"
    assert _demo_numbers(port_out)["pass"]


def test_config1_matches_reference(config1_both):
    """Both demos pass on their 12 frames: the same registered cameras,
    each ATE under the demo's 0.1 m, every held-out query under 0.2 m."""
    line, port_out, ref_line, ref_out = config1_both
    p, r = _demo_numbers(port_out), _demo_numbers(ref_out)
    assert line["pass"] and ref_line["pass"] and p["pass"] and r["pass"]
    assert p["registered"] == r["registered"] and p["cams"] == r["cams"] == 12
    assert p["ate_m"] < 0.1 and r["ate_m"] < 0.1
    assert len(p["pos_err_m"]) == len(r["pos_err_m"]) == 2
    assert max(p["pos_err_m"]) < 0.2 and max(r["pos_err_m"]) < 0.2


C2_FRAMES = 8


def _reference_config2(ref, n: int):
    """The reference's ``config2`` compiled with its walk length (the literal
    ``C = 32``) set to ``n``, in a copy of the reference module's globals."""
    src = (ROOT / "bench" / "run_configs.py").read_text()
    fn = next(f for f in ast.parse(src).body
              if isinstance(f, ast.FunctionDef) and f.name == "config2")
    hits = [a for a in ast.walk(fn) if isinstance(a, ast.Assign)
            and [getattr(t, "id", None) for t in a.targets] == ["C"]
            and isinstance(a.value, ast.Constant) and a.value.value == 32]
    assert len(hits) == 1
    hits[0].value = ast.Constant(n)
    mod = ast.fix_missing_locations(ast.Module(body=[fn], type_ignores=[]))
    ns = dict(vars(ref))
    exec(compile(mod, str(ROOT / "bench" / "run_configs.py"), "exec"), ns)
    return ns["config2"]


@pytest.fixture(scope="module")
def config2_both(ref):
    """Config 2 at C2_FRAMES frames through both harnesses, each package's
    ``build_map``, ``build_localization_map`` and ``localize_query``
    recorded.  Returns {package: (line, builds, map calls, query calls)}."""
    out = {}
    for name, fn, pipe, loc in (
            ("reference", _reference_config2(ref, C2_FRAMES), rpipe, rlocalize),
            ("port", lambda: rc.config2("cpu", n_frames=C2_FRAMES), tpipe, tlocalize)):
        builds, maps, queries = [], [], []
        with pytest.MonkeyPatch.context() as m:
            m.setattr(pipe, "build_map", _passthrough_out(builds, pipe.build_map))
            m.setattr(loc, "build_localization_map",
                      _passthrough_out(maps, loc.build_localization_map))
            m.setattr(loc, "localize_query", _passthrough(queries, loc.localize_query))
            line = fn()
        out[name] = (line, builds, maps, queries)
    return out


def test_config2_at_a_few_frames(config2_both):
    """The port's config 2 beside the reference's on the same 8 frames:
    registered cameras equal, each ATE under 0.1 m and within 0.01 m of
    the other (F1's keypoints move the builds apart), median inliers of
    the per-frame localization within 10 %."""
    line, ref_line = config2_both["port"][0], config2_both["reference"][0]
    assert line["n_frames"] == ref_line["n_frames"] == C2_FRAMES
    assert line["n_registered"] == ref_line["n_registered"] >= C2_FRAMES - 1
    assert line["ate_m"] < 0.1 and ref_line["ate_m"] < 0.1
    assert abs(line["ate_m"] - ref_line["ate_m"]) <= 0.01
    assert line["localize_fps"] > 0 and line["median_inliers"] > 0
    assert abs(line["median_inliers"] - ref_line["median_inliers"]) <= \
        0.1 * ref_line["median_inliers"]


def test_config2_localization_inputs(config2_both):
    """In each package ``build_localization_map`` gets the build's scene,
    descriptors, observation-to-feature table and keypoint mask, and the
    i-th ``localize_query`` that map, frame i's descriptors, keypoints and
    mask, the shared intrinsics, and RANSAC noise keyed (reference) or seeded (port)
    with i."""
    intrs = []
    for name, (_line, builds, maps, queries) in config2_both.items():
        assert len(builds) == len(maps) == 1 and len(queries) == C2_FRAMES
        (_a, _k, (scene, feats, tt, _stats)), (ma, mk, lmap) = builds[0], maps[0]
        if name == "reference":
            assert ma[0] is scene and mk.keys() == {"kp_mask"}
        else:
            for k, v in scene.to_numpy().items():
                _same(ma[0][k], v)
            assert ma[3] == torch.device("cpu") and mk.keys() == {"kp_mask"}
        _same(ma[1], feats.desc)
        _same(ma[2], tt.obs_feat)
        _same(mk["kp_mask"], feats.kp.mask)
        for i, (qa, qk) in enumerate(queries):
            assert qa[0] is lmap
            _same(qa[1], feats.desc[i])
            _same(qa[2], feats.kp.uv[i])
            _same(qa[3], feats.kp.mask[i])
            intrs.append(_np(qa[4]))
            if name == "reference":
                _same(qa[5], jax.random.PRNGKey(i))
            else:
                assert qk["generator"].initial_seed() == i
    for x in intrs:
        _same(x, np.array([280.0, 280.0, 160.0, 120.0, 0, 0, 0], np.float32))


# ---------------------------------------------------------------------------
# Keys and failure paths
# ---------------------------------------------------------------------------


def _dict_keys(node) -> tuple[set, bool]:
    """The string keys of a dict literal, and whether it spreads (``**``)."""
    keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
    return keys, any(k is None for k in node.keys)


def _reference_keys() -> dict:
    """Each reference function's returned dict literal's keys (the last
    ``return {...}`` of the function), and the block script's printed
    dict's; a spread (``**``) is marked."""
    tree = ast.parse((ROOT / "bench" / "run_configs.py").read_text())
    out = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef):
            rets = [n.value for n in ast.walk(fn)
                    if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
            if rets:
                out[fn.name] = _dict_keys(rets[-1])
    script = ast.parse((ROOT / "bench_scripts" / "block_ba_real_scene.py").read_text())
    out["block_ba_real_scene"] = next(_dict_keys(n) for n in ast.walk(script)
                                      if isinstance(n, ast.Dict) and "cost0" in
                                      _dict_keys(n)[0])
    return out


def test_json_keys_are_the_reference_keys(config4_small, built, config1_both, config2_both):
    """Every config's line: the reference's keys (its source's dict
    literals; the layout's stats where it spreads them), ``device`` added
    by ``main``."""
    keys = _reference_keys()
    stats = set(rlayout.build_block_layout(np.zeros(4, np.int32), np.arange(4, dtype=np.int32),
                                           np.zeros((4, 2), np.float32),
                                           np.ones(4, np.float32), 1, 4, 1).stats())
    line4, _ = config4_small
    k4, spread4 = keys["config4"]
    assert spread4 and set(line4) == k4 | stats
    kb, spreadb = keys["block_ba_real_scene"]
    assert spreadb and set(built[0]["block_ba"]) == kb | stats
    k2s, _ = keys["config2_scale"]
    assert set(built[0]) == k2s | {"block_ba"}            # config4_build adds block_ba
    assert set(rc.config3("cpu", C=8, P=100, O=800, iters=2, cg_iters=4)) == keys["config3"][0]
    assert set(config2_both["port"][0]) == keys["config2"][0]
    assert set(config1_both[0]) == keys["config1"][0] | {"device"}
    serve = rc.config5_serve("cpu", fps=8)
    assert set(serve) == keys["config5_serve"][0] and serve["shards"] == 4
    with pytest.MonkeyPatch.context() as m:
        m.setattr(rc, "config5", lambda device: {k: 0 for k in keys["config5"][0]})
        line = rc.main(["--config", "5", "--device", "cpu"])
    assert set(line) == keys["config5"][0] | {"device"}


def test_http_transport_needs_aiohttp_and_pil(monkeypatch):
    """5-serve's queries go over HTTP: without aiohttp or PIL it raises,
    naming the package, before it builds anything."""
    for mod in ("aiohttp", "PIL"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, mod, None)
            m.setattr(tpipe, "build_map", _recorder([]))
            with pytest.raises(RuntimeError, match=mod):
                rc.config5_serve("cpu", fps=48)


def test_png_frames_need_pil(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        rc.write_png_frames(tmp_path, np.zeros((1, 4, 4), np.float32))


def test_png_frames_decode_to_their_bits(tmp_path):
    """The PNG files hold a frame's 8 bits (``(img * 255)`` truncated, as the
    reference writes them) and the command line's decoder reads them back
    as those bits / 255, in file-name order."""
    from sfmx_torch.cli import ingest

    frames = np.random.default_rng(0).uniform(0, 1, (3, 24, 32)).astype(np.float32)
    frames[0, 0, :2] = (0.0, 1.0)
    paths = rc.write_png_frames(tmp_path, frames)
    assert ingest.list_images(tmp_path) == paths
    for f, p in zip(frames, paths):
        img, size = ingest._load_gray(p, (32, 24))
        _same(img, (f * 255).astype(np.uint8).astype(np.float32) / 255.0)
        assert size == (32, 24)


def test_harness_imports_neither_jax_nor_sfmx():
    code = ("import sys, torch; torch.set_num_threads(2); "
            "from sfmx_torch import run_configs as rc; "
            "rc.main(['--config', '5', '--device', 'cpu']); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sfmx')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()
    assert last[-1] == "[]"
    assert json.loads(last[-2])["config"] == 5
