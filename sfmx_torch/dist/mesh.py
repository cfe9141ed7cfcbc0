"""Process groups for the multi-device paths (port of ``sfmx.dist.mesh``).

The reference's ``jax.sharding`` mesh over one axis becomes the default
``torch.distributed`` process group: rank r of a world of n holds block r
of whatever the mesh axis sharded.  NCCL carries the collectives between
CUDA devices, gloo between CPU processes; a rank's device is
``cuda:<local rank>`` unless the caller asks for the CPU, and nothing falls
back from one to the other.

``spawn`` starts a world of processes on one host (``torch.multiprocessing``
with the spawn start method), each joined to the group through a
``file://`` store in a fresh temporary directory, so concurrent worlds on
one machine never share a port.  Ranks started apart (one command a rank,
on one host or several) join through a ``tcp://`` address instead: each
process calls ``run_rank`` (or ``init_group``) with its own rank, the world
size and the address of rank 0's store, e.g.

    python -m sfmx_torch.dist.mesh MODULE:FUNCTION --rank R --world-size N \
        --init-method tcp://HOST:PORT [--device cuda|cpu] [--args JSON list]

in each of the N processes, rank 0's host listening on PORT.  The rank
functions are the same as under ``spawn``.  ``--device cuda`` puts rank r on
cuda:r; where a host's ranks do not start at 0, name each one's card
(``--device cuda:<i>``).  Nothing here reads a cluster's environment.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device: torch.device | str) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if str(device).startswith("cuda") else "gloo"


def rank_device(local_rank: int, device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:<local rank>`` for ``"cuda"``, the CPU for
    ``"cpu"``, or one named card (``"cuda:0"``) for every rank (gloo ranks
    can share a card; NCCL refuses two ranks on one).  A missing card
    raises; there is no silent CPU fallback."""
    if device == "cpu":
        return torch.device("cpu")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda', 'cuda:<i>' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank_device({device!r}): torch.cuda.is_available() is False")
    index = local_rank if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} has no card {index}: "
                           f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


def init_group(backend: str, rank: int, world_size: int, init_method: str,
               timeout: float = 60.0, device: torch.device | None = None) -> None:
    """Join the default process group.  ``timeout`` (seconds) bounds every
    collective, so ranks whose control flow parted fail instead of hanging.
    NCCL binds the group to ``device`` (this rank's card)."""
    kw = {}
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(device)
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout), **kw)


def pad_to_multiple(x, m: int, axis: int = 0, fill=0):
    """Pad an array so axis length divides the world size."""
    n = x.shape[axis]
    r = (-n) % m
    if r == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, r)
    return np.pad(np.asarray(x), pads, constant_values=fill)


def run_rank(fn, rank: int, world_size: int, init_method: str, *, device: str = "cuda",
             backend: str | None = None, timeout: float = 60.0, args: tuple = ()) -> None:
    """Join the group as ``rank`` (``init_method``: ``file://`` or
    ``tcp://``), run ``fn(rank, world_size, device, *args)`` on this rank's
    device (``rank_device(rank, device)``), wait for every rank and leave
    the group."""
    backend = backend or default_backend(device)
    dev = rank_device(rank, device)
    init_group(backend, rank, world_size, init_method, timeout, dev)
    try:
        fn(rank, world_size, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn, world_size: int, backend: str, init_method: str,
               device: str, timeout: float, args: tuple) -> None:
    run_rank(fn, rank, world_size, init_method, device=device, backend=backend,
             timeout=timeout, args=args)


def spawn(fn, world_size: int, *args, device: str = "cuda", backend: str | None = None,
          timeout: float = 60.0, join_timeout: float = 600.0) -> None:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` processes,
    each joined to a process group (``backend`` None: NCCL for ``"cuda"``,
    gloo for ``"cpu"``).  ``fn`` must be importable by the children (a
    module-level function).  Raises if a rank fails, and kills every rank
    still running after ``join_timeout`` seconds."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(device)
    tmp = tempfile.mkdtemp(prefix="sfmx_dist_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                             args=(fn, world_size, backend, init, device, timeout, args))
    deadline = time.monotonic() + join_timeout
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"spawned world of {world_size} ranks did not finish "
                                   f"in {join_timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    """One rank of a world whose ranks are started apart (module docstring)."""
    import argparse
    import importlib
    import json

    p = argparse.ArgumentParser(prog="python -m sfmx_torch.dist.mesh",
                                description=main.__doc__)
    p.add_argument("function", help="MODULE:FUNCTION, called as f(rank, world, device, *args)")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True, help="tcp://HOST:PORT of rank 0's store")
    p.add_argument("--device", default="cuda", help="cuda (rank r on cuda:r), cuda:<i> or cpu")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    p.add_argument("--timeout", type=float, default=60.0, help="collective timeout, s")
    p.add_argument("--args", default="[]", help="JSON list of the function's further arguments")
    a = p.parse_args(argv)
    mod, name = a.function.split(":")
    fn = getattr(importlib.import_module(mod), name)
    run_rank(fn, a.rank, a.world_size, a.init_method, device=a.device, backend=a.backend,
             timeout=a.timeout, args=tuple(json.loads(a.args)))


if __name__ == "__main__":
    main()
