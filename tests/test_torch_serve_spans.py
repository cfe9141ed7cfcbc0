"""The serving path's spans: one batch through
``LocalizationService._run_batch`` under ``torch.profiler`` on the CPU, of
image requests and of feature requests, on the streaming path against
``test_torch_serve.py``'s room map.  Every span of a batch appears by name,
inside its parent, in order, apart from its siblings; the batch writes no
stage record; its answers are those of the same batch without the
profiler.  With no profiler recording, a span opens no range at all."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sfmx_torch.cli.config import FeatureConfig, LocalizeConfig, PipelineConfig
from sfmx_torch.serve import LocalizationService
from sfmx_torch.serve.server import _Request
from sfmx_torch.utils import logging as slog
from tests.test_torch_serve import INTR, _pcfg, room_map  # noqa: F401 (room_map: a fixture)

LOCALIZE = ("serve.localize", [("serve.stack", []), ("localize.match", []),
                               ("localize.ransac", []), ("localize.ransac", []),
                               ("localize.refine", []), ("serve.readback", []),
                               ("serve.respond", [])])
SPANS = {"image": [("serve.batch", [("serve.extract", [("extract", [])]), LOCALIZE])],
         "features": [("serve.batch", [LOCALIZE])]}


def _batch(room_map, payload):
    if payload == "image":
        return [_Request("room", None, None, image=im) for im in room_map["frames"]]
    return [_Request("room", None, None, q_desc=d, q_uv=u, q_mask=m)
            for d, u, m in zip(*room_map["q"])]


def _service(room_map):
    svc = LocalizationService(batch_window_ms=5.0, max_batch=8, seed=7)
    svc.load_map("room", room_map["tmap"], INTR,
                 cfg=_pcfg(PipelineConfig, FeatureConfig, LocalizeConfig, "on"))
    return svc


def _nest(ranges):
    """(name, start, end) ranges as a tree [(name, children)] by
    containment; a range that starts inside another and ends after it
    fails."""
    root = []
    open_ = [(float("inf"), root, None)]
    for name, a, b in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while a >= open_[-1][0]:
            open_.pop()
        assert b <= open_[-1][0], f"{name} [{a}, {b}] overlaps {open_[-1][2]}"
        kids = []
        open_[-1][1].append((name, kids))
        open_.append((b, kids, name))
    return root


@pytest.mark.parametrize("payload", ["image", "features"])
def test_batch_spans_nest_in_order(room_map, payload, tmp_path, capsys):
    svc = _service(room_map)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = svc._run_batch(_batch(room_map, payload))
    assert '"stage"' not in capsys.readouterr().err, "the batch wrote a stage record"
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert _nest(ranges) == SPANS[payload]

    want = _service(room_map)._run_batch(_batch(room_map, payload))
    assert all(isinstance(a, dict) for _r, a in got)
    assert [a for _r, a in got] == [a for _r, a in want]


def test_span_opens_a_range_only_while_a_profiler_records(monkeypatch):
    opened = []
    monkeypatch.setattr(slog, "record_function", lambda name: opened.append(name) or
                        torch.profiler.record_function(name))
    with slog.span("serve.off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with slog.span("serve.on"):
            torch.ones(2).add_(1)
    assert opened == ["serve.on"]
    assert "serve.on" in {e.key for e in prof.key_averages()}
