#!/usr/bin/env python3
"""Where a build on the card stops being bit-reproducible, and what the
card's process groups accept.

    python3 chip_experiments/f10_sites.py [--no-build] [--no-probes] [--root TREE]

Needs a CUDA card.  Prints:

- the installation: torch and CUDA versions, which collective names
  ``torch.distributed`` has (``all_gather_single`` / ``reduce_scatter_single``
  beside ``all_gather_into_tensor`` / ``reduce_scatter_tensor``), whether
  NCCL is built in, and whether gloo takes CUDA tensors for the four
  collectives the port uses (2 gloo ranks on ``cuda:0``);
- ``segment_sum.segment_sum`` (the fixed-order kernel over a stable sort)
  on a (200,000 x 36) f32 table by 512 ids twice and with the rows of equal
  ids in another order: whether its bits repeat, beside ``index_add_``'s;
- with ``--root TREE``, the ``sfmx_torch`` under TREE is measured (e.g. a
  parent commit's, from ``git archive <commit> sfmx_torch | tar -x -C TREE``);
  ``--no-probes`` skips the two items above;
- unless ``--no-build``: the 96 frames of the walk through ``build_map``
  under a ``TorchDispatchMode`` that records every CUDA call of an op that
  accumulates with atomics (``index_add``, ``index_put`` with accumulate,
  ``scatter_add``, ``scatter_reduce``, ``index_reduce``, ``put`` with
  accumulate, ``bincount`` with weights) by the first frame of
  ``sfmx_torch`` that made it; then two more builds with one seed compared
  array by array; then one build under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, which names
  every op with no deterministic CUDA implementation.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_gather_single", "reduce_scatter_single")


def gloo_cuda_rank(rank: int, init: str, out: str) -> None:
    """One gloo rank on cuda:0: which collectives take CUDA tensors."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    res = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            res[name] = "absent"
            continue
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if name == "all_reduce":
                    fn(x)
                    ok = x.tolist() == [1.0, 3.0, 5.0, 7.0]
                elif name.startswith("all_gather"):
                    o = torch.empty(8, device=dev)
                    fn(o, x)
                    ok = o.tolist() == [0, 1, 2, 3, 1, 2, 3, 4]
                else:
                    o = torch.empty(2, device=dev)
                    fn(o, x)
                    ok = o.tolist() == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])
            res[name] = "ok" if ok else "wrong values"
        except Exception as e:  # what the installation says is the finding
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def probe_installation() -> None:
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    names = {n: hasattr(dist, n) for n in COLLECTIVES}
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available(),
                      "names": names}), flush=True)
    d = tempfile.mkdtemp()
    out = os.path.join(d, "gloo.json")
    mp.spawn(gloo_cuda_rank, args=(f"file://{d}/store", out), nprocs=2, join=True)
    print("gloo on cuda:0 with 2 ranks: " + Path(out).read_text(), flush=True)


def probe_segment_sum() -> None:
    import torch

    from sfmx_torch.kernels import segment_sum as ss

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    O, C = 200_000, 512
    x = torch.randn((O, 36), generator=g, device=dev)
    ids = torch.randint(0, C, (O,), generator=g, device=dev)
    plan = ss.segment_plan(ids, C)
    a = ss.segment_sum(x, plan)
    b = ss.segment_sum(x, plan)
    # the rows of equal ids in another order: the fixed order is the sorted
    # one, so a shuffled table gives other (still repeatable) bits
    shuf = torch.randperm(O, generator=g, device=dev)
    plan2 = ss.segment_plan(ids[shuf], C)
    c = ss.segment_sum(x[shuf], plan2)
    c2 = ss.segment_sum(x[shuf], plan2)
    ia = torch.zeros((C, 36), device=dev).index_add_(0, ids, x)
    ib = torch.zeros((C, 36), device=dev).index_add_(0, ids, x)
    ref = torch.zeros((C, 36), dtype=torch.float64, device=dev).index_add_(0, ids, x.double())
    torch.cuda.synchronize()
    print(json.dumps({
        "segment_sum twice bit-equal": bool(torch.equal(a, b)),
        "shuffled twice bit-equal": bool(torch.equal(c, c2)),
        "shuffled vs unshuffled max abs": float((a - c).abs().max()),
        "index_add_ twice bit-equal": bool(torch.equal(ia, ib)),
        "index_add_ twice entries differing": int((ia != ib).sum()),
        "segment_sum vs f64 max abs": float((a.double() - ref).abs().max()),
        "index_add_ vs f64 max abs": float((ia.double() - ref).abs().max()),
    }), flush=True)


ATOMIC_OPS = ("index_add", "index_add_", "index_put", "index_put_", "_index_put_impl_",
              "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
              "index_reduce", "index_reduce_", "put", "put_", "bincount")


def atomic_calls(fn):
    """Run fn under a dispatch mode; return {op @ first sfmx_torch frame: calls}
    of the CUDA calls that accumulate with atomics."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: dict[str, int] = {}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name in ATOMIC_OPS:
                flat = [a for a in list(args) + list(kwargs.values())
                        if isinstance(a, torch.Tensor)]
                cuda = any(a.is_cuda for a in flat)
                accumulate = True
                if name.startswith(("index_put", "_index_put", "put")):
                    accumulate = bool(kwargs.get("accumulate", args[-1] if len(args) > 2
                                                 and isinstance(args[-1], bool) else False))
                if name == "bincount":
                    accumulate = kwargs.get("weights", args[1] if len(args) > 1 else None) \
                        is not None
                if cuda and accumulate:
                    where = "?"
                    for fr in reversed(traceback.extract_stack()[:-1]):
                        if "sfmx_torch" in fr.filename:
                            rel = fr.filename[fr.filename.index("sfmx_torch"):]
                            where = f"{rel}:{fr.lineno}"
                            break
                    key = f"{name} @ {where}"
                    seen[key] = seen.get(key, 0) + 1
            return func(*args, **kwargs)

    with Mode():
        out = fn()
    return out, seen


def probe_build() -> None:
    import torch

    import chip_smoke
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import build_map
    from tests import smoke_scenes

    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    poses = smoke_scenes.loop_walk_poses(chip_smoke.N_BAND)[:chip_smoke.N_BUILD]
    frames = smoke_scenes.render_parallel(0, poses, chip_smoke.W_IMG, chip_smoke.H_IMG,
                                          chip_smoke.FOCAL, chip_smoke.RENDER_WORKERS)
    n = len(frames)
    cfg = PipelineConfig()

    def build():
        scene, feats, _tt, stats = build_map(
            frames, chip_smoke.INTR[None], np.zeros(n, np.int32), cfg, dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        arrays = {f.name: getattr(scene, f.name).detach().cpu().numpy()
                  for f in dataclasses.fields(scene)
                  if isinstance(getattr(scene, f.name), torch.Tensor)}
        fn = feats.to_numpy()
        arrays.update({f"feats.kp.{k}": v for k, v in fn.kp._asdict().items()})
        arrays.update({"feats.desc": fn.desc, "feats.desc_bits": fn.desc_bits})
        return arrays, {k: v for k, v in stats.items() if k not in chip_smoke.CLI_TIMING_KEYS}

    t0 = time.perf_counter()
    _, sites = atomic_calls(build)
    print(f"atomic CUDA calls in one build ({time.perf_counter() - t0:.1f} s traced): "
          + json.dumps(sites), flush=True)
    a, sa = build()
    b, sb = build()
    differ = {k: float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
              if a[k].shape == b[k].shape and a[k].dtype != bool else "flags/shape"
              for k in a if not np.array_equal(a[k], b[k])}
    print("two builds, one seed: arrays bit-identical " + str(not differ)
          + ("" if not differ else " differing " + json.dumps(differ))
          + f"; registered {sa.get('n_registered')} / {sb.get('n_registered')}, "
          f"seed pairs {sa.get('init_pairs')} / {sb.get('init_pairs')}", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c, _ = build()
    torch.use_deterministic_algorithms(False)
    msgs = sorted({str(x.message).split("\n")[0][:200] for x in w
                   if "deterministic" in str(x.message)})
    same = all(np.array_equal(a[k], c[k]) for k in a)
    print("under use_deterministic_algorithms(True, warn_only=True): ops without a "
          f"deterministic CUDA implementation {json.dumps(msgs)}; its arrays bit-identical "
          f"with the builds above {same}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("f10_sites.py needs a CUDA card")
    args = sys.argv[1:]
    if "--root" in args:
        sys.path.insert(0, str(Path(args[args.index("--root") + 1]).resolve()))
    import sfmx_torch  # noqa: F401  (sets the TF32 flags)

    print(f"measuring {Path(sfmx_torch.__file__).parent}", flush=True)
    if "--no-probes" not in args:
        probe_installation()
        probe_segment_sum()
    if "--no-build" not in args:
        probe_build()
    return 0


if __name__ == "__main__":
    sys.exit(main())
