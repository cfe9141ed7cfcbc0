#!/usr/bin/env python3
"""Time K4 match_top2 and K2 response_levels of two source trees on one CUDA
card, in turns inside one run, so that the two can be compared (the wall and
the clocks differ between runs, and between cards).

    python3 chip_experiments/compare_trees.py PARENT_ROOT [CHANGE_ROOT]

Each root is a directory that holds a ``sfmx_torch`` package (for the parent,
e.g. ``git archive <commit> sfmx_torch | tar -x -C <dir>``); CHANGE_ROOT
defaults to this repository.  The trees run as parent, change, change,
parent, each in a process of its own (its kernels build into its own
``sfmx_torch/_build``).  Per tree and shape one JSON line: CUDA-event ms of
the wrapper call (median of 9), of the launch alone on bf16 inputs, and the
device ms by torch.profiler (10 calls), with the card's name and power limit.

Shapes: K4 at the serving batch's 32,768 query rows and at the serving
burst's tail of 2,048 rows against 133,120 landmarks of random unit
descriptors (D = 128); K2 at B = 32 and B = 2, 5 levels, 480x640 and 240x320.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

KB = 133120


def cuda_ms(fn, reps: int = 9, warm: int = 3) -> float:
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 10) -> float:
    """Summed device time per call under torch.profiler; traced again where
    the profiler returns no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError("the profiler recorded no device time")


def measure(root: str, tag: str) -> None:
    """Runs in a process of its own with ``root`` first on the path."""
    sys.path.insert(0, root)
    import torch

    import sfmx_torch
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.kernels import scale_space as ss

    if not Path(sfmx_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {sfmx_torch.__file__}, not the tree under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator().manual_seed(0)

    def unit(n):
        x = torch.randn((n, 128), generator=g)
        return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dev)

    out = {"tree": tag, "card": smi}
    pool = unit(KB)
    pool16 = pool.bfloat16().contiguous()
    for Ka in (32768, 2048):
        q = unit(Ka)
        q16 = q.bfloat16().contiguous()
        if hasattr(mt, "_match_top2_cuda"):
            def launch():
                mt._match_top2_cuda(q16, pool16)
        else:       # a tree whose wrapper holds the launch itself: call its library
            lib = mt._lib()
            s1 = torch.empty((Ka,), dtype=torch.float32, device=dev)
            s2 = torch.empty_like(s1)
            i1 = torch.empty((Ka,), dtype=torch.int32, device=dev)

            def launch():
                err = lib.mt_match_top2(q16.data_ptr(), pool16.data_ptr(), Ka, KB, s1.data_ptr(),
                                        i1.data_ptr(), s2.data_ptr(), _build.stream_ptr(dev))
                if err:
                    raise RuntimeError(f"mt_match_top2 returned {err}")
        out[f"K4 {Ka}x{KB}"] = {"wrapper_ms": cuda_ms(lambda: mt.match_top2(q, pool)),
                                "launch_ms": cuda_ms(launch), "device_ms": device_ms(launch)}
    for B in (32, 2):
        for H, W in ((480, 640), (240, 320)):
            lv = torch.rand((B, 5, H, W), generator=g).to(dev)

            def k2():
                ss.response_levels(lv, (2, 3, 4, 5, 6))

            out[f"K2 B={B} {H}x{W}"] = {"wrapper_ms": cuda_ms(k2), "device_ms": device_ms(k2)}
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        measure(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__)
        return 2
    parent = str(Path(sys.argv[1]).resolve())
    change = str(Path(sys.argv[2] if len(sys.argv) == 3 else Path(__file__).parent.parent).resolve())
    for tag, root in (("parent", parent), ("change", change), ("change", change),
                      ("parent", parent)):
        subprocess.run([sys.executable, __file__, "--measure", root, tag], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
