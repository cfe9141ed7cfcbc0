"""The benchmark of ``sfmx_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (at the root of the checkout) on the
card this process is started on, and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit (also the last lines of standard error).

Everything is found by name: the cell's configuration file
(``BENCHMARK.json``'s ``configs[].file``) names its driver
(``portbench/drivers/<driver>.py``); the cell's traffic mix is
``portbench/traffic/<traffic>.json``; each metric is read by
``portbench/metrics/<metric>.py``'s ``read(ctx)``, which returns nothing
where it finds nothing to read.

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 3 and prints no result; so it does if a JAX module is loaded once the
window has closed (code 4).
"""
import os
import sys
import time

T_START = time.time()
# steadiness: fixed thread counts for every library and worker process
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness

    spec = harness.load_cell(ROOT, a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"portbench: {a.workload} needs {spec['cell']['chips']} CUDA card(s); "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(spec, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                           T_START, ROOT)
    return harness.report(spec, out, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
