"""The port's bench (``sfmx_torch.bench``) against ``bench.py``.

Input parity at bench.py's own sizes: each reference function runs with
its entry point patched to record its arguments and raise (``jax.jit``
the identity for that call, so the records are concrete arrays), the
port's function the same way with the port's entry patched, and the two
records are compared array for array and argument for argument.  No
full-size work runs: the inputs are numpy draws.  Then the formulas under
one fake clock, the example map (F13), and the port's bench at small sizes
on the CPU: its JSON line, its failure paths and the ``bench`` command.
"""
import contextlib
import dataclasses
import functools
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as rbench
import examples.room
import sfmx.cli.pipeline as rpipe
import sfmx.kernels.features  # noqa: F401  (imported before jax.jit is patched)
import sfmx.kernels.matching as rmatching
import sfmx.kernels.segsum  # noqa: F401
import sfmx.localize.localize as rloc
import sfmx.localize.tracking as rtracking
import sfmx.serve.server as rserver
import sfmx.solvers.lm as rlm
import sfmx_torch.bench as tb
import sfmx_torch.cli.main as tmain
import sfmx_torch.cli.pipeline as tpipe
import sfmx_torch.kernels.matching as tmatching
import sfmx_torch.localize.localize as tloc
import sfmx_torch.localize.tracking as ttracking
import sfmx_torch.serve.server as tserver
import sfmx_torch.solvers.lm as tlm

torch.set_num_threads(2)


class _Stop(Exception):
    """Raised by a recording entry: the inputs are all the test needs."""


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _same_map(ref, port):
    for k, v in ref._asdict().items():
        if v is None:
            assert getattr(port, k) is None, k
        else:
            _same(v, getattr(port, k))


def _same_config(ref, port):
    """Equal in every field both dataclasses have."""
    r, p = dataclasses.asdict(ref), dataclasses.asdict(port)

    def diff(a, b, path=""):
        out = []
        for k in a.keys() & b.keys():
            if isinstance(a[k], dict) and isinstance(b[k], dict):
                out += diff(a[k], b[k], f"{path}{k}.")
            elif a[k] != b[k]:
                out.append((path + k, a[k], b[k]))
        return out

    assert diff(r, p) == []


def _recorder(calls, result=None):
    def rec(*a, **k):
        calls.append((a, k))
        if result is None:
            raise _Stop
        return result
    return rec


@contextlib.contextmanager
def _no_jit(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f=None, **kw: f if f is not None else (lambda g: g))
        yield m


def _ref_call(monkeypatch, patches, fn, *args):
    """Run the reference's ``fn`` with ``patches`` ((obj, name, value), ...)
    and jax.jit the identity, until a recording entry raises."""
    with _no_jit(monkeypatch) as m:
        for obj, name, value in patches:
            m.setattr(obj, name, value)
        with pytest.raises(_Stop):
            fn(*args)


def _port_call(monkeypatch, patches, fn, *args):
    with monkeypatch.context() as m:
        for obj, name, value in patches:
            m.setattr(obj, name, value)
        with pytest.raises(_Stop):
            fn(*args)


def _seed(gen: torch.Generator) -> int:
    return gen.initial_seed()


# ---------------------------------------------------------------------------
# F13: the example map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,C,Kc,seed", [
    (256, 16, 64, 0),          # __graft_entry__'s defaults
    (128, 8, 32, 3),           # the dry run's map at world size 2
    (8192, 256, 256, 0),       # bench.py: the headline's and tracking's map
    (100_352, 512, 256, 0),    # streaming
    (20000, 128, 256, 0),      # serving
])
def test_example_map_matches_reference(P, C, Kc, seed):
    ref = graft._example_map(P=P, C=C, D=128, Kc=Kc, seed=seed)
    _same_map(ref, tb.example_map(P, C, 128, Kc, seed, "cpu"))


# ---------------------------------------------------------------------------
# Input parity at bench.py's sizes
# ---------------------------------------------------------------------------


def _fake_pose(K, xp):
    if xp is torch:
        return types.SimpleNamespace(R=torch.eye(3), t=torch.zeros(3), n_inliers=torch.tensor(K),
                                     confidence=torch.tensor(1.0))
    return types.SimpleNamespace(R=jnp.eye(3), t=jnp.zeros(3), n_inliers=jnp.asarray(K),
                                 confidence=jnp.asarray(1.0))


@pytest.mark.parametrize("half", ["gather", "streaming"])
def test_tripwire_inputs(monkeypatch, half):
    """Both halves of the gate see the reference's map, query and
    arguments; the gather half's result is faked for the streaming half."""
    K = rbench.K_FEAT
    rq, rs, pq, ps = [], [], [], []
    fake = half == "streaming"
    _ref_call(monkeypatch, [
        (rloc, "localize_query", _recorder(rq, _fake_pose(K, jnp) if fake else None)),
        (rloc, "localize_batch_streaming", _recorder(rs))], rbench.accuracy_tripwire)
    _port_call(monkeypatch, [
        (tloc, "localize_query", _recorder(pq, _fake_pose(K, torch) if fake else None)),
        (tloc, "localize_batch_streaming", _recorder(ps))], tb.accuracy_tripwire, "cpu")
    (ra, rk), (pa, pk) = (rs[0], ps[0]) if fake else (rq[0], pq[0])
    _same_map(ra[0], pa[0])
    for r, p in zip(ra[1:5], pa[1:5]):
        _same(r, p)
    _same(ra[5], jax.random.PRNGKey(7))
    assert _seed(pk.pop("generator")) == 7
    assert rk == pk


def test_matching_inputs(monkeypatch):
    r, p = [], []
    _ref_call(monkeypatch, [(rmatching, "match_pairs_float_auto", _recorder(r))],
              rbench.matching_throughput, 100.0)
    _port_call(monkeypatch, [(tmatching, "match_pairs_float_auto", _recorder(p))],
               tb.matching_throughput, 100.0, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    assert len(ra) == len(pa) == 3 and rk == pk == {}
    for x, y in zip(ra, pa):
        _same(x, y)


def test_matching_band_inputs(monkeypatch):
    r, p = [], []
    _ref_call(monkeypatch, [(rmatching, "match_pairs_float_auto", _recorder(r))],
              rbench.matching_throughput_band, 100.0)
    _port_call(monkeypatch, [(tmatching, "match_pairs_float_auto", _recorder(p))],
               tb.matching_throughput_band, 100.0, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    assert rk == pk == {} and len(pa[2]) == len(ra[2])
    for x, y in zip(ra, pa):
        _same(x, y)


def test_ba_inputs(monkeypatch):
    """The same problem and solve settings; the reference's cam_window is a
    TPU fence the port does not take."""
    r, p = [], []
    _ref_call(monkeypatch, [(rlm, "ba_solve", _recorder(r))], rbench.ba_throughput, 1000.0)
    _port_call(monkeypatch, [(tlm, "ba_solve", _recorder(p))], tb.ba_throughput, 1000.0, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    assert len(ra) == len(pa) == 10
    for x, y in zip(ra, pa):
        _same(x, y)
    rk.pop("cam_window")
    assert rk == pk == dict(iters=10, cg_iters=30, tp_cap=32, dense_cg=True)


def test_streaming_inputs(monkeypatch):
    r, p = [], []
    _ref_call(monkeypatch, [(rloc, "localize_batch_streaming", _recorder(r))],
              rbench.streaming_localize_fps)
    _port_call(monkeypatch, [(tloc, "localize_batch_streaming", _recorder(p))],
               tb.streaming_localize_fps, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    _same_map(ra[0], pa[0])
    for x, y in zip(ra[1:5], pa[1:5]):
        _same(x, y)
    _same(ra[5], jax.random.PRNGKey(0))
    assert _seed(pk.pop("generator")) == 0 and rk == pk == {"k_hypotheses": 512}


def test_tracking_inputs(monkeypatch):
    """The reference's whole-sequence scan and the port's per-frame loop get
    the same map, frames and TrackingConfig."""
    r, p = [], []
    _ref_call(monkeypatch, [(rtracking, "_sequence_scan", _recorder(r))], rbench.tracking_fps)
    _port_call(monkeypatch, [(ttracking, "localize_sequence", _recorder(p))],
               tb.tracking_fps, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    _same_map(ra[0], pa[0])
    for x, y in zip(ra[1:5], pa[1:5]):
        _same(x, y)
    _same(ra[5], jax.random.split(jax.random.PRNGKey(0), 64))
    assert dataclasses.asdict(ra[6]) == dataclasses.asdict(pa[5])
    assert _seed(pk.pop("generator")) == 0 and rk == pk == {}


def test_geometric_verify_inputs(monkeypatch):
    """The same points, pairs and matches; the port's Gumbel noise is drawn
    for the reference's hypothesis count."""
    r, p = [], []
    _ref_call(monkeypatch, [(rmatching, "geometric_verify_pairs", _recorder(r))],
              rbench.geometric_verify_pairs_per_s)
    _port_call(monkeypatch, [(tmatching, "geometric_verify_pairs", _recorder(p))],
               tb.geometric_verify_pairs_per_s, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    for x, y in zip(ra[1:4], pa[1:4]):
        _same(x, y)
    for x, y in zip(ra[4], pa[4]):
        _same(x, y)
    _same(ra[0], jax.random.PRNGKey(0))
    Np, K = ra[4].idx.shape
    assert tuple(pa[0].shape) == (Np, rk.pop("k_hypotheses"), K)
    assert rk == pk == {"threshold": 1e-5}


def test_extract_inputs(monkeypatch):
    r, p = [], []
    _ref_call(monkeypatch, [(rpipe, "_extract_raw", _recorder(r))], rbench.extract_stream_fps)
    _port_call(monkeypatch, [(tpipe, "_extract_raw", _recorder(p))],
               tb.extract_stream_fps, "cpu")
    (ra, rk), (pa, pk) = r[0], p[0]
    _same(ra[0], pa[0])
    _same_config(ra[1], pa[1])
    assert pa[1].features.max_keypoints == 512 and rk == pk == {}


def _serving_patches(cls, inits, loads, calls):
    init = cls.__init__

    def rec_init(self, *a, **k):
        inits.append((a, k))
        init(self, *a, **k)

    def rec_load(self, *a, **k):
        loads.append((a, k))

    async def rec_localize(self, *a, **k):
        calls.append((a, k))
        raise _Stop

    return [(cls, "__init__", rec_init), (cls, "load_map", rec_load),
            (cls, "localize", rec_localize)]


def test_serving_inputs(monkeypatch):
    """The service's settings, the served map and intrinsics, and each
    request's features."""
    ri, rl, rc, pi, pl, pc = [], [], [], [], [], []
    _ref_call(monkeypatch, _serving_patches(rserver.LocalizationService, ri, rl, rc),
              rbench.serving_p95_ms)
    _port_call(monkeypatch, _serving_patches(tserver.LocalizationService, pi, pl, pc),
               tb.serving_p95_ms, "cpu")
    assert ri == pi == [((), {"batch_window_ms": 5.0, "max_batch": 16})]
    (ra, rk), (pa, pk) = rl[0], pl[0]
    assert ra[0] == pa[0] == "m"
    _same_map(ra[1], pa[1])
    _same(ra[2], pa[2])
    _same_config(rk.pop("cfg"), pk.pop("cfg"))
    assert rk == pk == {}
    assert len(rc) == len(pc) == 16
    for (ra, rk), (pa, pk) in zip(rc, pc):
        assert ra[0] == pa[0] == "m" and rk == pk == {}
        for x, y in zip(ra[1:], pa[1:]):
            _same(x, y)


def test_map_build_inputs(monkeypatch):
    """The same frames asked of the renderer (which returns zeros here), the
    same intrinsics, camera groups and build config."""
    rr, rb, pr, pb = [], [], [], []

    def render(log):
        def rec(*a):
            log.append(a)
            return np.zeros((a[4], a[3]))
        return rec

    monkeypatch.setattr(sys, "path", list(sys.path))     # bench.py inserts its root
    _ref_call(monkeypatch, [(examples.room, "render_room", render(rr)),
                            (rpipe, "build_map", _recorder(rb))], rbench.map_build_fps)
    _port_call(monkeypatch, [(examples.room, "render_room", render(pr)),
                             (tpipe, "build_map", _recorder(pb))], tb.map_build_fps, "cpu")
    assert len(rr) == len(pr) == 96
    for a, b in zip(rr, pr):
        for g, h in zip(a[0].grids, b[0].grids):
            _same(g, h)
        for x, y in zip(a[1:], b[1:]):
            _same(x, y)
    (ra, rk), (pa, pk) = rb[0], pb[0]
    for x, y in zip(ra[:3], pa[:3]):
        _same(x, y)
    _same_config(ra[3], pa[3])
    assert _seed(pk.pop("generator")) == 0
    assert (pa[3].match.pair_mode, pa[3].match.window, pa[3].resize_to) == ("window", 12,
                                                                            (320, 240))
    assert rk == pk == {}


def test_cpu_baseline_without_cv2(monkeypatch):
    """Without cv2 both return None, so vs_baseline is null."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert rbench.cpu_baseline_frames_per_s() is None
    assert tb.cpu_baseline_frames_per_s() is None


def test_cpu_baseline_with_cv2():
    pytest.importorskip("cv2")
    fps = tb.cpu_baseline_frames_per_s()
    assert np.isfinite(fps) and fps > 0


# ---------------------------------------------------------------------------
# Formulas, under one fake clock
# ---------------------------------------------------------------------------


def _clock():
    state = [0.0]

    def tick():
        state[0] += 1.0
        return state[0]
    return tick


@pytest.mark.parametrize("name,rentry,pentry,rfake,pfake", [
    ("matching_throughput", (rmatching, "match_pairs_float_auto"),
     (tmatching, "match_pairs_float_auto"), types.SimpleNamespace(score=jnp.zeros(1)), 0),
    ("matching_throughput_band", (rmatching, "match_pairs_float_auto"),
     (tmatching, "match_pairs_float_auto"), types.SimpleNamespace(score=jnp.zeros(1)), 0),
    ("ba_throughput", (rlm, "ba_solve"), (tlm, "ba_solve"), (0, 0, 0, jnp.zeros(2)), 0),
])
def test_formula_matches_reference(monkeypatch, name, rentry, pentry, rfake, pfake):
    """MFU as 2K^2D per pair over the measured peak, BA traffic as 252 B per
    observation per CG step over the measured rate: with the entries faked
    and each package's clock ticking 1 s a read, both give the same numbers."""
    with _no_jit(monkeypatch) as m:
        m.setattr(*rentry, lambda *a, **k: rfake)
        m.setattr(rbench, "time", types.SimpleNamespace(time=_clock()))
        ref = getattr(rbench, name)(123.0)
    with monkeypatch.context() as m:
        m.setattr(*pentry, lambda *a, **k: pfake)
        m.setattr(tb, "time", types.SimpleNamespace(perf_counter=_clock()))
        port = getattr(tb, name)(123.0, "cpu")
    assert port == pytest.approx(ref, rel=1e-12)
    if name == "ba_throughput":
        assert port[1] == pytest.approx(port[0] * 30 * 200000 * 252.0 / 123e9, rel=1e-12)
    else:
        assert port[1] == pytest.approx(port[0] * 2 * 512 * 512 * 128 / 123e12, rel=1e-12)


# ---------------------------------------------------------------------------
# The port's bench on the CPU
# ---------------------------------------------------------------------------

SMALL = {
    "accuracy_tripwire": {},
    "tpu_frames_per_s": dict(B=2, H=96, W=128, P=512, C=16, K=64, reps=1),
    "measure_peaks": dict(n=128, chain=4, m=1 << 16, reps=1),
    "matching_throughput": dict(C=8, K=64, npairs=16, reps=2),
    "matching_throughput_band": dict(C=32, K=32, reps=1),
    "ba_throughput": dict(C=32, P=200, O=2000, iters=2, cg_iters=5),
    "streaming_localize_fps": dict(B=2, K=64, P=4096, C=16, reps=1),
    "tracking_fps": dict(N=4, K=64, P=512, C=16),
    "geometric_verify_pairs_per_s": dict(Np=8, K=64, H=16, reps=1),
    "extract_stream_fps": dict(B=2, H=64, W=96, K=64, reps=1),
    "serving_p95_ms": dict(P=512, C=16, B=4, K=64),
    "map_build_fps": dict(frames=8, width=160, height=120),
}


def _reference_keys(monkeypatch, capsys) -> set:
    """The keys of bench.py's JSON line, from its main with every function
    stubbed."""
    stubs = {"accuracy_tripwire": None, "tpu_frames_per_s": (1.0, 1.0),
             "cpu_baseline_frames_per_s": 1.0, "measure_peaks": (1.0, 1.0),
             "matching_throughput": (1.0, 1.0), "matching_throughput_band": (1.0, 1.0),
             "ba_throughput": (1.0, 1.0), "streaming_localize_fps": 1.0, "tracking_fps": 1.0,
             "geometric_verify_pairs_per_s": 1.0, "extract_stream_fps": 1.0,
             "serving_p95_ms": 1.0, "map_build_fps": (1.0, {"ba_path": {"mode": "dense"}})}
    with monkeypatch.context() as m:
        m.setattr(jax.config, "update", lambda *a, **k: None)
        for k, v in stubs.items():
            m.setattr(rbench, k, lambda *a, v=v, **kw: v)
        capsys.readouterr()
        rbench.main()
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


def test_main_prints_bench_keys_on_cpu(monkeypatch, capsys):
    """Every function at small sizes through main on the CPU (the tripwire
    at its full size, both halves): one JSON line,
    last, with exactly bench.py's keys plus ``device``; every rate finite
    and positive; no kernel launched (CPU tensors take the plain versions)."""
    keys = _reference_keys(monkeypatch, capsys)
    for name, kw in SMALL.items():
        fn = getattr(tb, name)
        monkeypatch.setattr(tb, name, functools.update_wrapper(functools.partial(fn, **kw), fn))
    line, launches = tb.main("cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert set(line) == keys | {"device"}
    assert line["device"] == {"name": "cpu", "power_limit": None, "count": 1}
    assert (line["metric"], line["unit"]) == ("query_localization_throughput", "frames/s/chip")
    assert line["map_build_ba_path"] == "planes"
    for k, v in line.items():
        if k not in ("metric", "unit", "device", "map_build_ba_path", "vs_baseline"):
            assert np.isfinite(v) and v > 0, (k, v)
    detail = json.loads(out[-2])
    assert detail["launches"] == launches and "published" not in detail
    assert set(launches) == set(SMALL) and not any(launches.values())


@pytest.mark.parametrize("failing", ["accuracy_tripwire", "tpu_frames_per_s",
                                     "ba_throughput", "map_build_fps"])
def test_main_raises_on_a_failing_sub_bench(monkeypatch, capsys, failing):
    """A failure anywhere raises out of main, and no JSON line is printed:
    nothing is caught and nothing retried."""
    stubs = {"accuracy_tripwire": None, "tpu_frames_per_s": (1.0, 1.0),
             "measure_peaks": (1.0, 1.0), "matching_throughput": (1.0, 1.0),
             "matching_throughput_band": (1.0, 1.0), "ba_throughput": (1.0, 1.0),
             "streaming_localize_fps": 1.0, "tracking_fps": 1.0,
             "geometric_verify_pairs_per_s": 1.0, "extract_stream_fps": 1.0,
             "serving_p95_ms": 1.0, "map_build_fps": (1.0, {}),
             "cpu_baseline_frames_per_s": None}
    calls = []
    for k, v in stubs.items():
        def stub(*a, k=k, v=v, **kw):
            calls.append(k)
            if k == failing:
                raise RuntimeError(f"{k} failed")
            return v
        stub.__name__ = k
        monkeypatch.setattr(tb, k, stub)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        tb.main("cpu")
    assert calls.count(failing) == 1 and calls[0] == "accuracy_tripwire"
    assert not any(ln.startswith("{") for ln in capsys.readouterr().out.splitlines())


def test_bench_command_runs_main(monkeypatch):
    seen = []
    monkeypatch.setattr(tb, "main", lambda device: seen.append(device))
    tmain.main(["bench", "--device", "cpu"])
    assert seen == ["cpu"]
    assert "bench" not in tmain._NOT_PORTED


def test_bench_command_needs_a_card(monkeypatch):
    """The default device is cuda: without a card the command raises
    torch's own error before any work (with one, the stubbed tripwire)."""
    def reached(*a, **k):
        raise RuntimeError("reached the bench")

    monkeypatch.setattr(tb, "accuracy_tripwire", reached)
    with pytest.raises((AssertionError, RuntimeError)):
        tmain.main(["bench"])
