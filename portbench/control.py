"""The control of a serving cell's comparison: the plain reference put in
the program's place at the precision below the configuration's (its
``control`` entry: extraction in bfloat16, K4's inputs in float8 e4m3, the
pose's inputs and result in bfloat16), judged by the same check as the
program.  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--sample 32]

One JSON line a seed: its numbers, each with its limit, and ``correct``.
The benchmark's own runs never run it.
"""
import os
import sys
import time

T_START = time.time()
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def control_numbers(spec: dict, seed: int, device, sample: int, overrides=None) -> dict:
    import torch

    from portbench import harness, seeding
    from portbench.drivers import serve
    from portbench.scenes.building import building

    cfg = harness.deep_merge(spec["cfg"], overrides or {})
    traffic = harness.deep_merge(spec["traffic"], (overrides or {}).get("traffic", {}))
    images = traffic["payload"] == "image"
    b = building(cfg, seed, device)
    rng = seeding.rng(seed, 17)
    pids = [int(p) for p in rng.integers(cfg["pool"], size=sample)]
    ctl = cfg["control"]
    lowp = serve.reference_records(
        cfg, b, pids, device, seed=seed + 1,
        extract_dtype=getattr(torch, ctl["extraction"]) if images else None,
        cast=lambda x: x.to(getattr(torch, ctl["matching"])).to(torch.float32),
        geometry_bf16=True)
    numbers = serve.check(cfg, b, lowp, device, images=images, seed=seed)
    return {"seed": seed, "correct": harness.correct(numbers), "info": dict(serve.INFO),
            "numbers": {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sample", type=int, default=32)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 3
    spec = harness.load_cell(ROOT, a.workload)
    for s in a.seeds.split(","):
        print(json.dumps(control_numbers(spec, int(s), torch.device("cuda", 0), a.sample)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
