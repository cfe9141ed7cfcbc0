"""The readers of the program's serving spans, on a synthetic Chrome trace
through ``portbench.trace.Digest``: nested host ranges of one batch, the
launches of its device operations (by correlation id) and the gaps between
them, all with known durations, checked by hand; nothing where the trace
has no such span or there is no trace."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.trace import Digest  # noqa: E402

TID = 7
# one image batch as the program's spans nest inside the benchmark's
# wrappers, in microseconds
RANGES = [("portbench.batch", 0, 1000), ("serve.batch", 1, 999),
          ("portbench.extract", 2, 100), ("serve.extract", 3, 99), ("extract", 10, 50),
          ("portbench.localize", 100, 1000), ("serve.localize", 101, 999),
          ("serve.stack", 102, 200), ("localize.match", 200, 400),
          ("localize.ransac", 400, 500), ("localize.ransac", 500, 700),
          ("localize.refine", 700, 850), ("serve.readback", 850, 900),
          ("serve.respond", 900, 998)]
# device operations: (start, end, launched at); each launch lies in the
# innermost range named in the comment
OPS = [(20, 40, 15),        # extract
       (70, 75, 55),        # serve.extract, after extract closed
       (150, 160, 120),     # serve.stack
       (300, 380, 210),     # localize.match
       (450, 470, 410),     # localize.ransac (the draw)
       (600, 640, 520),     # localize.ransac (the hypotheses)
       (770, 790, 710),     # localize.refine
       (870, 880, 860),     # serve.readback
       (1030, 1040, 960)]   # serve.respond
# each gap between operations is named by the range open at its middle:
# [40, 70] serve.extract, [75, 150] serve.stack, [160, 300] localize.match,
# [380, 450] + [470, 600] localize.ransac, [640, 770] + [790, 870]
# localize.refine, [880, 1030] serve.respond
REQUESTS = 4
WANT_US = {"idle_ms_per_req.serve.extract": 30,
           "idle_ms_per_req.serve.stack": 75,
           "idle_ms_per_req.localize.match": 140,
           "idle_ms_per_req.localize.ransac": 70 + 130,
           "idle_ms_per_req.localize.refine": 130 + 80,
           "idle_ms_per_req.serve.respond": 150,
           "device_ms_per_req.localize.ransac": 20 + 40,
           "device_ms_per_req.localize.refine": 20}


def _events(ranges):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a, "tid": TID}
          for n, a, b in ranges]
    for i, (a, b, at) in enumerate(OPS):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a,
                   "tid": 1, "args": {"correlation": 100 + i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at,
                   "dur": 2, "tid": TID, "args": {"correlation": 100 + i}})
    return ev


def _ctx(trace, requests=REQUESTS):
    return {"trace": trace, "work": {"requests": requests, "images": requests}}


def test_digest_names_gaps_and_launches_by_program_span():
    d = Digest(_events(RANGES), window_s=1e-3)
    assert d.busy_s == pytest.approx(sum(b - a for a, b, _ in OPS) * 1e-6)
    assert d.idle["localize.ransac"] == pytest.approx(200e-6)
    assert d.in_range["serve.localize"] == pytest.approx((10 + 80 + 20 + 40 + 20 + 10 + 10) * 1e-6)
    assert d.in_range["extract"] == pytest.approx(20e-6)
    assert "portbench.localize" not in d.idle and "serve.localize" not in d.idle


@pytest.mark.parametrize("metric", sorted(WANT_US))
def test_span_reader_by_hand(metric):
    read = harness.reader(metric)
    assert read(_ctx(Digest(_events(RANGES), window_s=1e-3))) == \
        pytest.approx(WANT_US[metric] * 1e-3 / REQUESTS)
    # the parent's program opens no such span: its trace gives nothing to read
    parent = [r for r in RANGES if not r[0].startswith(("serve.", "localize."))]
    assert read(_ctx(Digest(_events(parent), window_s=1e-3))) is None
    assert read(_ctx(None)) is None
    assert read(_ctx(Digest(_events(RANGES), window_s=1e-3), requests=0)) is None
