"""The traced run: torch.profiler over the window, reduced to a digest.

The profiler's Chrome trace is read back once: device operations (kernels,
copies, sets) with their names and times; the host's named ranges (the
program's ``LOGGER`` stages and the benchmark's own ``portbench.*`` spans);
and each kernel's launch, joined by correlation id, so device time can be
attributed to the host range that launched it.
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """torch.profiler driven from the service's own batch thread.

    The profiler records host operations only on the thread that starts it,
    so the loop thread asks (``request``) and the batch thread acts
    (``poll``, before traffic and at the start of each batch): ``begin``
    enters the profiler's warm-up phase (its set-up cost falls before the
    window), ``start`` records, ``stop`` ends.  The traced window runs from the first batch
    after the window opens to the first batch ``seconds`` later, or after
    the window closes, whichever comes first."""

    def __init__(self, enabled: bool, seconds: float = 0.0):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.pending: list[str] = []
        self.t_open = self.t_close = None
        self.marks: dict[str, object] = {}

    def request(self, action: str):
        if self.enabled:
            self.pending.append(action)

    def poll(self, mark=None):
        if (self.t_open is not None and self.t_close is None and self.seconds
                and time.perf_counter() - self.t_open >= self.seconds
                and "stop" not in self.pending):
            self.pending.append("stop")
        while self.pending:
            action = self.pending.pop(0)
            if action == "begin":
                import torch

                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(
                    activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
                self.prof.__enter__()
            elif action == "start":
                self.prof.step()
                self.t_open = time.perf_counter()
                self.marks["start"] = mark() if mark else None
            elif action == "stop" and self.t_close is None:
                self.t_close = time.perf_counter()
                self.marks["stop"] = mark() if mark else None
                self.prof.__exit__(None, None, None)

    def digest(self, path: str) -> "Digest | None":
        if self.prof is None or self.t_close is None:
            return None
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Digest(events, self.t_close - self.t_open)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Digest:
    """Device time by operation name and by launching host range, busy time
    and idle gaps, in seconds."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        dev, ranges, launch = [], [], {}
        self.counts: dict[str, int] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            self.counts[cat] = self.counts.get(cat, 0) + 1
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat == "user_annotation":
                ranges.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                               e["name"], e.get("tid")))
            elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
        self.by_name: dict[str, float] = {}
        for e in dev:
            self.by_name[e["name"]] = self.by_name.get(e["name"], 0.0) + float(e.get("dur", 0)) * 1e-6
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev]
        merged = _union(spans)
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        # device time by the host range (any enclosing one, by name) that launched it
        by_range: dict[str, list] = {}
        for a, b, name, tid in ranges:
            by_range.setdefault((name, tid), []).append((a, b))
        self.in_range: dict[str, float] = {}
        for (name, tid), iv in by_range.items():
            iv = _union(iv)
            starts = [a for a, _ in iv]
            tot = 0.0
            for e in dev:
                ln = launch.get(e.get("args", {}).get("correlation"))
                if ln is None or ln[1] != tid:
                    continue
                i = bisect.bisect_right(starts, ln[0]) - 1
                if i >= 0 and ln[0] <= iv[i][1]:
                    tot += float(e.get("dur", 0)) * 1e-6
            self.in_range[name] = self.in_range.get(name, 0.0) + tot
        # idle gaps between device operations, named by the innermost host
        # range open at the gap's middle (the open range that started last)
        self.idle: dict[str, float] = {}
        order = sorted(ranges)
        heap, j = [], 0
        for (a0, b0), (a1, _b1) in zip(merged, merged[1:]):
            mid = 0.5 * (b0 + a1)
            while j < len(order) and order[j][0] <= mid:
                heapq.heappush(heap, (-order[j][0], order[j][1], order[j][2]))
                j += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "(no range)"
            self.idle[name] = self.idle.get(name, 0.0) + (a1 - b0) * 1e-6

    def kernel_s(self, needle: str) -> float:
        return sum(v for k, v in self.by_name.items() if needle in k)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:96], v] for k, v in top],
                "idle_gaps": [[k[:96], v] for k, v in gaps]}
