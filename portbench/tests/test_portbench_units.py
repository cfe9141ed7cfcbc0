"""Units of the harness: roofline work, window statistics, traffic
generation, discovery by name, the module guard, the frozen scene copies."""
import asyncio
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import guard, harness, load, roofline, window  # noqa: E402


def test_fed_steps_by_hand():
    # T = 2.5, 3.5, 4.5, 5.5 need n(n+1)/12 >= T: n = 5, 6, 7, 8
    assert roofline.fed_steps() == [5, 6, 7, 8]


def test_match_top2_work_by_hand():
    w = roofline.match_top2_work(rows=1000, landmarks=2 ** 20, dim=128)
    assert w["ops"] == 2 * 1000 * 2 ** 20 * 128
    assert w["bytes"] == (1000 + 2 ** 20) * 128 * 2 + 1000 * 12
    t, by = roofline.bound_s(w)
    assert by == "operations" and t == pytest.approx(w["ops"] / 989e12)
    assert roofline.share(w, 2 * t) == pytest.approx(50.0)
    assert roofline.share(w, 0.0) is None


def test_diffuse_work_by_hand():
    w = roofline.diffuse_segment_work(images=2, height=480, width=640, octaves=2)
    px = 2 * (480 * 640 + 240 * 320)
    assert w["ops"] == 30 * px * 26
    assert w["bytes"] == 4 * 2 * px * 4
    assert roofline.bound_s(w)[1] == "operations"


def test_rate_is_over_the_whole_window():
    recs = [{"ok": True, "t_done": t} for t in (0.5, 1.5, 9.9, 10.0, 10.5)]
    done = window.completed_in(recs, 0.0, 10.0)
    assert len(done) == 3
    assert window.rate(len(done), 10.0) == 0.3


def test_p95_over_every_request_and_a_stall_moves_both():
    steady = [100.0] * 1000
    assert window.percentile(steady, 95) == 100.0
    # a 2 s stall: the 60 requests caught in it wait, and 20 fewer finish
    stalled = [100.0] * 920 + [2000.0] * 60
    assert window.percentile(stalled, 95) == 2000.0
    assert window.rate(len(stalled), 10.0) < window.rate(len(steady), 10.0)
    assert window.percentile(list(range(1, 101)), 95) == 95


def test_open_loop_times_from_due_and_counts_failures():
    async def main():
        gen = load.Load({"arrival": "burst", "burst": 3, "period_s": 0.05, "warmup_s": 0.0},
                        seed=5, pool=4)

        async def submit(seq, pid):
            await asyncio.sleep(0.01)
            if seq % 4 == 3:
                raise RuntimeError("refused")
            return {"seq": seq}

        t0, t1 = await gen.run(submit, 0.3)
        return gen, t0, t1

    gen, t0, t1 = asyncio.run(main())
    sent = [r for r in gen.records if t0 <= r["t_sent"] < t1]
    assert len(sent) >= 9 and len(sent) % 3 == 0
    assert all(r["t_done"] is not None for r in gen.records)
    assert sum(not r["ok"] for r in gen.records) == len(gen.records) // 4
    assert all(0 <= r["pid"] < 4 for r in gen.records)


def test_poisson_and_closed_arrivals_run():
    async def main(traffic):
        gen = load.Load(traffic, seed=1, pool=8)

        async def submit(seq, pid):
            await asyncio.sleep(0.002)
            return seq

        await gen.run(submit, 0.2)
        return gen.records

    assert len(asyncio.run(main({"arrival": "poisson", "rate_rps": 200.0}))) > 10
    recs = asyncio.run(main({"arrival": "closed", "clients": 4}))
    assert len(recs) > 20 and all(r["ok"] for r in recs)


def test_every_cell_resolves_by_name():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in names:
        assert callable(harness.reader(m)), m
    for w in bench["workloads"]:
        spec = harness.load_cell(ROOT, w["name"], bench)
        assert spec["cfg"]["name"] == w["config"]
        assert spec["traffic"]["name"] == w["traffic"]
        assert harness.driver(spec["cfg"]["driver"]).run
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["sfmx_torch", "sfmx_torch.serve.server", "jaxtyping",
                                   "portbench", "numpy"]) == []
    assert guard.forbidden_loaded(["sfmx.cli", "jax._src", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "sfmx"]


def test_torch_renderer_equals_the_frozen_numpy_renderer():
    import torch

    from portbench.scenes import room

    tex = room.RoomTexture(seed=3 ** 25)
    poses = room.walk_poses(4)
    a = np.stack([room.render_room(tex, R, e, 96, 72, 84.0) for R, _t, e in poses])
    b = room.render_room_torch(tex, [R for R, _, _ in poses], [e for _, _, e in poses], 96, 72,
                               84.0, torch.device("cpu"))
    assert np.abs(a - b).max() < 1e-6
