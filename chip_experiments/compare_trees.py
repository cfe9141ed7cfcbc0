#!/usr/bin/env python3
"""Time K4 match_top2, K2 response_levels, K3 describe_upright, K8
ba_cost_fused, K5 match_pairs_fused, K9 match_pairs_tiled, K10
match_pairs_top2 and K7 ba_assemble_fused of two source trees on one CUDA
card, in turns inside one run, so that the two can be compared (the wall and
the clocks differ between runs, and between cards).

    python3 chip_experiments/compare_trees.py PARENT_ROOT [CHANGE_ROOT] [--kernels K5,K7]

Each root is a directory that holds a ``sfmx_torch`` package (for the parent,
e.g. ``git archive <commit> sfmx_torch | tar -x -C <dir>``); CHANGE_ROOT
defaults to this repository.  The trees run as parent, change, change,
parent, each in a process of its own (its kernels build into its own
``sfmx_torch/_build``).  Per tree and shape one JSON line: CUDA-event ms of
the wrapper call (median of 9), of the launch alone on bf16 inputs, and the
device ms by torch.profiler (10 calls), with the card's name and power limit.

Shapes: K4 at the serving batch's 32,768 query rows and at the serving
burst's tail of 2,048 rows against 133,120 landmarks of random unit
descriptors (D = 128); K2 at B = 32 and B = 2, 5 levels, 480x640 and 240x320;
K3 on the octave-0 levels and keypoints of 32 rendered serving frames (made
once, by this tree, and read by every measuring process) and on random
levels of the same sizes at B = 32, 16 and 2 (1,024 keypoints an image at
480x640, 512 at 240x320, placed uniformly, each at a random level with that
level's sigma); K8 with 4 and 1 candidates on a random problem of
the 96-frame build's size (96 cameras, 2,267 points, tp = 64) and on ba-512
(512 cameras, 20,000 points, 200,000 observations, tp = 32), each through
the call ``ba_solve`` makes in its tree (a ``CostFused`` bound to the layout
where the tree has one).  K3 and K8 also by CUDA events around 20 calls
back to back (``b2b_ms``) and around the replay of a CUDA graph of 20 calls
(``graph_ms``, per call: their device time without the host's path and
without the profiler).

K5, K9 and K10 on random unit descriptors (D = 128, K = 1024) with random
masks (~90 % valid): K5 over the 4,560 exhaustive pairs of 96 images, K9
over a band list of 2,245 pairs of 256 images (every pair up to 8 apart and
233 random pairs further apart, as the band build's retrieval list), K10 raw
on the first 512 exhaustive pairs (masked rows zeroed).  K7 on the two K8
problems, through the call ``ba_solve`` makes in its tree (an
``AssembleFused`` bound to the layout where the tree has one).  For these
``launch_ms`` is the mean traced launch of each of the tree's own kernels
(CUDA kernels of ``sfmx_torch/csrc`` and the memsets they issue) summed over
them, with how many launches the trace kept (``traced``): a trace of a short
kernel called back to back drops launches.  A call that cannot be captured
into a CUDA graph (the matchers copy their pair lists from the host) is not
captured: its ``graph_ms`` is null.  ``--kernels`` picks a subset (default K4,K2,K3,K8).
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


def b2b_ms(fn, n: int = 20) -> float:
    """CUDA-event time per call of n calls back to back (the host's path
    overlaps the device's work past the first call)."""
    return cuda_ms(lambda: [fn() for _ in range(n)], reps=5, warm=1) / n


def graph_ms(fn, n: int = 20) -> float:
    """Device time per call from replaying a CUDA graph of n calls, timed by
    CUDA events: neither the host's path nor the profiler stands between the
    launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def served_k3_inputs(path: Path) -> None:
    """Octave 0 of the first serving batch of ``chip_smoke.py`` (32 rendered
    VGA frames): levels and detected keypoints, as its phase 3 makes them,
    saved to ``path``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    import chip_smoke as cs
    from sfmx_torch.kernels import features as F
    from sfmx_torch.kernels import scale_space as ss
    from tests import smoke_scenes

    frames = smoke_scenes.render_parallel(0, cs.serve_poses()[:cs.SERVE_BATCH], cs.W_IMG, cs.H_IMG,
                                          cs.FOCAL, cs.RENDER_WORKERS)
    cfg = F.ScaleSpaceConfig()
    levels, resp = ss.build_scale_space_and_response(torch.as_tensor(frames, device="cuda"), cfg)
    kp = F.detect(levels, resp, cfg, max_keypoints=1024, threshold=1e-7, with_orientation=False)
    torch.save({"levels": levels.contiguous(), "uv": kp.uv, "level": kp.level, "sigma": kp.sigma,
                "mask": kp.mask}, path)


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


def own_kernel(name: str) -> bool:
    """A kernel of the tree's own ``sfmx_torch/csrc`` (its anonymous
    namespace), or a memset that one of them issues."""
    return "anonymous namespace" in name or "Memset" in name


def timings(fn, reps: int = 9, graph: bool = True) -> dict:
    """One call by an event pair, 20 back to back, a graph of 20 (where the
    call can be captured), the mean traced launch (summed over the tree's
    kernels) and all device time."""
    from chip_smoke import launch_device_ms

    per: dict = {}
    total, _note = launch_device_ms(fn, 20, own_kernel, per)
    return {"one_call_ms": cuda_ms(fn, reps=reps), "b2b_ms": b2b_ms(fn),
            "graph_ms": graph_ms(fn) if graph else None, "launch_ms": total, "kernels": per,
            "device_ms": device_ms(fn, reps=10)}


def pair_inputs(dev, g):
    """Random unit descriptors and ~90 % masks for 256 images of K = 1024,
    the exhaustive pairs of the first 96, the band list over all 256 and the
    raw list (the first 512 exhaustive pairs)."""
    import numpy as np
    import torch

    C, K = 256, 1024
    x = torch.randn((C, K, 128), generator=g)
    d = (x / torch.linalg.vector_norm(x, dim=2, keepdim=True)).to(dev)
    m = (torch.rand((C, K), generator=g) < 0.9).to(dev)
    exh = np.array([(a, b) for a in range(96) for b in range(a + 1, 96)], np.int32)
    band = {(a, b) for a in range(C) for b in range(a + 1, min(a + 9, C))}
    rng = np.random.default_rng(0)
    while len(band) < 2245:
        a, b = sorted(rng.choice(C, 2, replace=False).tolist())
        if b - a > 8:
            band.add((a, b))
    return d, m, exh, np.array(sorted(band), np.int32)


def measure(root: str, tag: str, kernels: set[str], served: Path) -> None:
    """Runs in a process of its own with ``root`` first on the path."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))   # tests.smoke_scenes
    import torch

    import sfmx_torch
    from sfmx_torch.kernels import _build
    from sfmx_torch.kernels import describe as dsc
    from sfmx_torch.kernels import match as mt
    from sfmx_torch.kernels import scale_space as ss
    from sfmx_torch.kernels import segsum as sg

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
    pool = unit(KB) if "K4" in kernels else None
    pool16 = pool.bfloat16().contiguous() if "K4" in kernels else None
    for Ka in (32768, 2048) if "K4" in kernels else ():
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
    for B in (32, 2) if "K2" in kernels else ():
        for H, W in ((480, 640), (240, 320)):
            lv = torch.rand((B, 5, H, W), generator=g).to(dev)

            def k2():
                ss.response_levels(lv, (2, 3, 4, 5, 6))

            out[f"K2 B={B} {H}x{W}"] = {"wrapper_ms": cuda_ms(k2), "device_ms": device_ms(k2)}
    if "K3" in kernels:
        d = torch.load(served, map_location=dev)
        args = (d["levels"], d["uv"], d["level"], d["sigma"], d["mask"])

        def k3():
            dsc.describe_upright(*args)

        out[f"K3 served B=32 480x640 K=1024 ({int(d['mask'].sum())} keypoints)"] = {
            "wrapper_ms": cuda_ms(k3), "b2b_ms": b2b_ms(k3), "device_ms": device_ms(k3),
            "graph_ms": graph_ms(k3)}
        del d, args
    for B in (32, 16, 2) if "K3" in kernels else ():
        for (H, W), K in (((480, 640), 1024), ((240, 320), 512)):
            lv = torch.rand((B, 5, H, W), generator=g).to(dev)
            lvl = torch.randint(0, 5, (B, K), generator=g)
            uv = (torch.rand((B, K, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])).to(dev)
            sigma = (2.0 + lvl.float()).to(dev)                    # sigma levels 2..6
            mask = torch.ones((B, K), dtype=torch.bool, device=dev)
            args = (lv, uv, lvl.to(dev), sigma, mask)

            def k3():
                dsc.describe_upright(*args)

            out[f"K3 B={B} {H}x{W} K={K}"] = {"wrapper_ms": cuda_ms(k3), "b2b_ms": b2b_ms(k3),
                                               "device_ms": device_ms(k3), "graph_ms": graph_ms(k3)}
    if "K8" in kernels:
        from tests.smoke_scenes import ba_problem

        for name, (C, P, O, tp, window, longs) in {
                "build-sized": (96, 2267, 36000, 64, 24, 100),
                "ba-512": (512, 20000, 200000, 32, 16, 0)}.items():
            prob = {k: torch.as_tensor(v, device=dev) for k, v in
                    ba_problem(C, P, O, seed=0, window=window, perturb=0.03,
                               long_tracks=longs).items()}
            dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
            uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
            for nc in (4, 1):
                cams = torch.cat([sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"],
                                                     prob["t"] + 0.01 * c) for c in range(nc)], 0)
                xs = torch.cat([(prob["X"] + 0.005 * c).T for c in range(nc)], 0).contiguous()

                if hasattr(sg, "CostFused"):   # the call ba_solve makes: bound once per solve
                    cost = sg.CostFused(dense, uvw)

                    def k8():
                        cost(cams, xs, 0.008, nc)
                else:
                    def k8():
                        sg.ba_cost_fused(cams, dense, uvw, xs, 0.008, nc=nc)

                out[f"K8 {name} nc={nc}"] = {"wrapper_ms": cuda_ms(k8, reps=21), "b2b_ms": b2b_ms(k8),
                                             "device_ms": device_ms(k8, reps=20),
                                             "graph_ms": graph_ms(k8)}
    if kernels & {"K5", "K9", "K10"}:
        from sfmx_torch.kernels import pairs as mp
        from sfmx_torch.kernels import tiles as mtl

        d, m, exh, band = pair_inputs(dev, g)
        if "K5" in kernels:
            out["K5 exhaustive 4560 pairs K=1024"] = timings(
                lambda: mp.match_pairs_fused(d[:96], m[:96], exh, ratio=0.85), reps=5, graph=False)
        if "K9" in kernels:
            out[f"K9 band {len(band)} pairs K=1024"] = timings(
                lambda: mtl.match_pairs_float_tiled(d, m, band, ratio=0.85), reps=5, graph=False)
        if "K10" in kernels:
            dz = torch.where(m[:96, :, None], d[:96], 0.0)
            out["K10 raw 512 pairs K=1024"] = timings(lambda: mp.match_pairs_top2(dz, exh[:512]), graph=False)
        del d, m
    if "K7" in kernels:
        from tests.smoke_scenes import ba_problem

        for name, (C, P, O, tp, window, longs) in {
                "build-sized": (96, 2267, 36000, 64, 24, 100),
                "ba-512": (512, 20000, 200000, 32, 16, 0)}.items():
            prob = {k: torch.as_tensor(v, device=dev) for k, v in
                    ba_problem(C, P, O, seed=0, window=window, perturb=0.03,
                               long_tracks=longs).items()}
            dense = sg.build_dense_obs(prob["pt_id"], prob["cam_id"], P, C, tp)
            uvw = sg.pack_rows(dense, torch.cat([prob["uv"], prob["w_valid"][:, None]], 1))
            cam19 = sg.build_cam_table(prob["intr"], prob["k_idx"], prob["R"], prob["t"])
            x3 = prob["X"].T.contiguous()
            if hasattr(sg, "AssembleFused"):   # the call ba_solve makes: bound once per solve
                asm = sg.AssembleFused(dense, uvw)

                def k7():
                    asm(cam19, x3, 0.008)
            else:
                def k7():
                    sg.ba_assemble_fused(cam19, dense, uvw, x3, 0.008)

            out[f"K7 {name} O={int(dense.cnt.sum())}"] = timings(k7, reps=21)
    print(json.dumps(out), flush=True)


def main() -> int:
    args = sys.argv[1:]
    kernels = "K4,K2,K3,K8"
    if "--kernels" in args:
        i = args.index("--kernels")
        kernels = args[i + 1]
        del args[i:i + 2]
    served = Path(__file__).resolve().parent.parent / ".chip_scratch" / "served_k3.pt"
    if len(args) == 4 and args[0] == "--measure":
        measure(args[1], args[2], set(args[3].split(",")), served)
        return 0
    if len(args) not in (1, 2):
        print(__doc__)
        return 2
    parent = str(Path(args[0]).resolve())
    change = str(Path(args[1] if len(args) == 2 else Path(__file__).parent.parent).resolve())
    if "K3" in kernels.split(","):
        served.parent.mkdir(exist_ok=True)
        served_k3_inputs(served)
    try:
        for tag, root in (("parent", parent), ("change", change), ("change", change),
                          ("parent", parent)):
            subprocess.run([sys.executable, __file__, "--measure", root, tag, kernels], check=True)
    finally:
        served.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
