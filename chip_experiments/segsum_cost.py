#!/usr/bin/env python3
"""What the fixed-order segment sum costs on the card, beside ``index_add_``.

    python3 chip_experiments/segsum_cost.py

Needs a CUDA card.  On ba-512's observation table (512 cameras, 20,000
points, 200,000 observations, ``tests/smoke_scenes.ba_problem``) it times,
for the camera sum of an (O,36) and an (O,6) block and the point sum of an
(O,9) and an (O,3) block:

- ``index_add_`` into zeros (float atomics; the parent's sum);
- ``segment_sum.segment_sum`` on a plan (the hand-written kernel,
  ``csrc/segment_sum.cu``);
- ``segment_sum.segment_sum_plain`` (``torch.segment_reduce`` over the
  sorted rows: one thread a segment and column);

each as host microseconds per call (no synchronization, 200 calls) and
device microseconds per call (CUDA events around 200 calls back to back),
whether a call synchronizes with the host (``torch.cuda.set_sync_debug_mode``),
whether two calls repeat their bits, and the largest difference from an
f64 ``index_add_``.  Then LM iterations/s of the planes ``ba_solve`` with
the kernel and with ``index_add_`` (the parent's sum) in its place, in
turns over ROUNDS rounds, each the median of 3 solves after a warm one:
the host's speed drifts during a run, so only sums timed in turns compare.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 4
sys.path.insert(0, str(ROOT))


def index_add_sum(x, plan):
    """The parent's atomic sum, in x's order."""
    import torch

    return torch.zeros((plan.n, *x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add_(0, plan.ids, x)


def main() -> int:
    import numpy as np
    import torch

    import sfmx_torch  # noqa: F401
    from sfmx_torch.kernels import segment_sum as ss
    from sfmx_torch.solvers import lm, schur
    from tests.smoke_scenes import ba_problem

    if not torch.cuda.is_available():
        raise RuntimeError("segsum_cost.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    prob = {k: torch.as_tensor(v, device=dev) for k, v in
            ba_problem(512, 20000, 200000, seed=0, window=16, perturb=0.03).items()}
    perm = torch.argsort(prob["pt_id"], stable=True)
    cam, pt = prob["cam_id"][perm].long(), prob["pt_id"][perm].long()
    C, P, O = 512, 20000, cam.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"card": smi}
    for name, ids, n, k in (("camera (O,36)", cam, C, 36), ("camera (O,6)", cam, C, 6),
                            ("point (O,9)", pt, P, 9), ("point (O,3)", pt, P, 3)):
        x = torch.randn((O, k), generator=g, device=dev)
        plan = ss.segment_plan(ids, n)
        ways = {"index_add_": lambda: index_add_sum(x, plan),
                "kernel": lambda: ss.segment_sum(x, plan),
                "plain": lambda: ss.segment_sum_plain(x, plan)}
        ref = index_add_sum(x.double(), plan)
        row = {}
        for way, fn in ways.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(200):
                fn()
            b.record()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                fn()
            torch.cuda.set_sync_debug_mode(0)
            row[way] = {"host_us": host_us, "device_us": a.elapsed_time(b) / 200 * 1e3,
                        "syncs": len(w), "repeats": bool(torch.equal(fn(), fn())),
                        "max_abs_vs_f64": float((fn().double() - ref).abs().max())}
        out[name] = row

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.ba_solve(*prob.values(), iters=10, cg_iters=30)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rates = {}
    for _ in range(ROUNDS):
        for tag, fn in (("kernel", ss.segment_sum), ("index_add_ (atomics)", index_add_sum)):
            schur.segment_sum = fn
            solve()
            rates.setdefault(tag, []).append(10 / float(np.median([solve() for _ in range(3)])))
    schur.segment_sum = ss.segment_sum
    out["planes ba-512 LM iterations/s"] = rates
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
