"""Structured stage logging (port of ``sfmx.utils.logging``): one JSON line
per pipeline stage with its metrics (#matches, #inliers, pairs kept,
#tracks, wall seconds), so runs are machine-comparable.

A scope is also a ``torch.profiler.record_function`` range, so a profiler
trace shows the stages by name.  A stage's wall time is host time: it
covers the device work only where the stage waits for a result (each
stage of the map-build front end reads a count back, which does).
"""
from __future__ import annotations

import contextlib
import json
import sys
import time


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
        """Times a stage; the caller fills the yielded dict with metrics."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(stage):
            out = {}
            yield out
        self.log(stage, wall_s=round(time.perf_counter() - t0, 4), **extra, **out)


LOGGER = StageLogger()
