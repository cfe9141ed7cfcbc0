"""Spans and structured stage records (port of ``sfmx.utils.logging``).

Two separate things:

- ``span(name)``: a ``torch.profiler.record_function`` range and nothing
  else (no record, no readback, no clock read), so a profiler trace shows
  the code by name on the profiler's clock.  With no profiler recording it
  opens nothing and costs one check of the profiler's state.  The serving
  path opens only spans.
- ``LOGGER.scope(stage)``: a span that also writes one JSON line for the
  stage with its metrics (#matches, #inliers, pairs kept, #tracks, wall
  seconds), so runs are machine-comparable.  A stage's wall time is host
  time: it covers the device work only where the stage waits for a result
  (each stage of the map-build front end reads a count back, which does).
"""
from __future__ import annotations

import contextlib
import json
import sys
import time

import torch
from torch.profiler import record_function


def span(name: str) -> contextlib.AbstractContextManager:
    """A profiler range named ``name`` around a ``with`` block, opened only
    while a profiler records: a ``record_function`` enter or exit is an
    operator call that may hand the GIL to another thread, and a serving
    batch opens a dozen spans while the event loop's thread wants the GIL."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


class StageLogger:
    def __init__(self, stream=None, run_id: str | None = None):
        self._stream = stream  # None = resolve sys.stderr at log time
        self.run_id = run_id or f"run{int(time.time())}"

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stderr

    def log(self, stage: str, **metrics):
        rec = {"ts": round(time.time(), 3), "run": self.run_id, "stage": stage}
        rec.update(metrics)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    @contextlib.contextmanager
    def scope(self, stage: str, **extra):
        """Times a stage under ``span(stage)``; the caller fills the yielded
        dict with metrics."""
        t0 = time.perf_counter()
        with span(stage):
            out = {}
            yield out
        self.log(stage, wall_s=round(time.perf_counter() - t0, 4), **extra, **out)


LOGGER = StageLogger()
