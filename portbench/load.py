"""The general traffic generator: clients in the benchmark's own process.

A traffic file (``portbench/traffic/<name>.json``) gives its parameters:

- ``arrival``: ``closed`` (``clients`` clients, each sends its next request
  when its answer comes), ``poisson`` (independent arrivals at ``rate_rps``)
  or ``burst`` (``burst`` requests at once every ``period_s``);
- ``payload``: what a request carries, read by the driver (``image`` or
  ``features``);
- ``warmup_s``: traffic before the window opens, so the window starts in
  the steady state.

Each request draws its pool item from the seed.  A closed-loop request is
timed from the moment its client hands it over; an open-loop request from
the moment it was due, so a stall counts against every request it delays.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from . import seeding

DRAIN_S = 60.0


class Load:
    def __init__(self, traffic: dict, seed: int, pool: int):
        self.t = traffic
        self.pool = pool
        self.rng = seeding.rng(seed, 3)
        self.records: list[dict] = []
        self.seq = 0
        self.late_s = 0.0          # how far behind its schedule an open loop ran at most
        self._stop = False

    def _next(self) -> tuple[int, int]:
        s, self.seq = self.seq, self.seq + 1
        return s, int(self.rng.integers(self.pool))

    async def _one(self, submit, t_due: float):
        seq, pid = self._next()
        rec = {"seq": seq, "pid": pid, "t_sent": t_due, "ok": False, "t_done": None}
        self.records.append(rec)
        try:
            rec["result"] = await submit(seq, pid)
            rec["ok"] = True
        except Exception as e:  # a failed request is counted, never dropped
            rec["error"] = repr(e)
        rec["t_done"] = time.perf_counter()

    async def _closed(self, submit):
        async def client():
            while not self._stop:
                await self._one(submit, time.perf_counter())
        await asyncio.gather(*(client() for _ in range(int(self.t["clients"]))))

    async def _open(self, submit, gaps):
        tasks = []
        due = time.perf_counter()
        for gap in gaps:
            due += gap
            now = time.perf_counter()
            if due > now:
                await asyncio.sleep(due - now)
            if self._stop:
                break
            self.late_s = max(self.late_s, time.perf_counter() - due)
            for _ in range(int(self.t.get("burst", 1))):
                tasks.append(asyncio.ensure_future(self._one(submit, due)))
        await asyncio.gather(*tasks)

    def _gaps(self):
        kind = self.t["arrival"]
        while True:
            if kind == "poisson":
                yield float(self.rng.exponential(1.0 / float(self.t["rate_rps"])))
            elif kind == "burst":
                yield float(self.t["period_s"])
            else:
                raise ValueError(f"unknown arrival {kind!r}")

    async def run(self, submit, seconds: float, *, on_start=None, on_open=None, on_close=None):
        """Send traffic: ``warmup_s`` before the window, ``seconds`` in it,
        then wait for every answer (at most ``DRAIN_S``).  Returns
        (t_open, t_close) on ``time.perf_counter``'s clock."""
        if on_start:
            on_start()
        if self.t["arrival"] == "closed":
            sender = asyncio.ensure_future(self._closed(submit))
        else:
            sender = asyncio.ensure_future(self._open(submit, self._gaps()))
        await asyncio.sleep(float(self.t.get("warmup_s", 0.0)))
        t_open = time.perf_counter()
        if on_open:
            on_open()
        await asyncio.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        t_close = time.perf_counter()
        if on_close:
            on_close()
        self._stop = True
        try:
            await asyncio.wait_for(sender, DRAIN_S)
        except asyncio.TimeoutError:
            pass
        return t_open, t_close
