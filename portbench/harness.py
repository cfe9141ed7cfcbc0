"""The general harness: a cell of ``BENCHMARK.json`` resolved by name to its
configuration, traffic mix, driver and metric readers; one run; the
result line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str, bench: dict | None = None) -> dict:
    """The cell named ``workload``: its entry, configuration (from its
    file), traffic mix and the metrics it reports."""
    bench = bench or _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {"cell": cell, "cfg": cfg, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_name = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: str, overrides: dict | None = None) -> dict:
    """One run of the cell on ``device``; ``overrides`` shrink the
    configuration (the CPU tests' toy sizes)."""
    import torch

    torch.set_num_threads(1)
    overrides = dict(overrides or {})
    traffic = deep_merge(spec["traffic"], overrides.pop("traffic", {}))
    cfg = deep_merge(spec["cfg"], overrides)
    scratch = os.path.join(os.environ.get("TMPDIR") or root, f"portbench-{os.getpid()}")
    os.makedirs(scratch, exist_ok=True)
    try:
        out = driver(cfg["driver"]).run(cfg, traffic, seed, seconds, trace, device,
                                        t_start, scratch)
    finally:
        for f in os.listdir(scratch):
            os.remove(os.path.join(scratch, f))
        os.rmdir(scratch)
    out["metrics"] = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"])(out["ctx"])
        if v is not None:
            out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def correct(numbers: dict) -> bool:
    """Every reading at or under its limit, and enough requests checked."""
    ok = True
    for name, (value, limit) in numbers.items():
        if name == "checked":
            ok &= value >= limit
        else:
            ok &= math.isfinite(value) and value <= limit
    return bool(ok)


def result_line(spec: dict, out: dict, trace: bool, device_name: str, count: int) -> dict:
    dev = {"platform": "gpu", "kind": device_name, "count": count,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct(out["numbers"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    dig = out["ctx"].get("trace")
    if trace and dig is not None:
        dev["busy_s"] = dig.busy_s
        dev["window_s"] = dig.window_s
        line["breakdown"] = dig.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["numbers"].items()}
    return line


def report(spec: dict, out: dict, trace: bool) -> int:
    import torch

    from portbench import guard

    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(spec, out, trace, torch.cuda.get_device_name(0), spec["cell"]["chips"])
    parts = out["ctx"].get("setup_parts", {})
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f"; check {out['check_s']:.3f} s", file=sys.stderr)
    dig = out["ctx"].get("trace")
    if dig is not None:
        print("portbench: trace events " + json.dumps(dig.counts) + "; device time in ranges "
              + json.dumps(dig.in_range), file=sys.stderr)
    bt = sorted(out["ctx"]["window"].get("batch_ms", []))
    if bt:
        print(f"portbench: window batches {len(bt)}, ms median {bt[len(bt) // 2]:.2f} "
              f"p90 {bt[int(0.9 * (len(bt) - 1))]:.2f} max {bt[-1]:.2f}", file=sys.stderr)
    info = getattr(driver(spec["cfg"]["driver"]), "INFO", {})
    if info:
        print("portbench: check saw " + json.dumps(info), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
