"""Rank functions of the port's multi-process tests (``test_torch_halo``,
``test_torch_dist``, ``test_torch_block_ba``, ``test_torch_sharded``).

``sfmx_torch.dist.mesh.spawn`` starts each rank as a fresh interpreter that
imports this module to find its function, so it imports neither jax nor
``sfmx``: only numpy, torch and the port.  Each function reads its inputs
from an npz the test wrote and writes ``rank<r>.npz`` beside it; the test
compares those with the reference in its own process.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)


def _load(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _save(path, rank: int, **arrays) -> None:
    out = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in arrays.items()}
    np.savez(Path(path).parent / f"rank{rank}.npz", **out)


def halo_rank(rank: int, n: int, dev, inp: str) -> None:
    """ring_all_reduce, ring_reduce_scatter and halo_gather on this rank's
    inputs (``x_ar``, ``x_rs``, ``vals``/``idx``/``msk`` stacked by rank)."""
    from sfmx_torch.dist import halo

    z = _load(inp)
    T = lambda a: torch.as_tensor(a[rank], device=dev)
    _save(inp, rank, ring=halo.ring_all_reduce(T(z["x_ar"])),
          own=halo.ring_reduce_scatter(T(z["x_rs"])),
          g=halo.halo_gather(T(z["vals"]), T(z["idx"]), T(z["msk"])))


def dist_rank(rank: int, n: int, dev, inp: str) -> None:
    """The observation-sharded LM on two problems (``a_*``: the reference's
    parity scene; ``b_*``: its two-process bootstrap problem), and
    data-parallel extraction of ``imgs``."""
    from sfmx_torch.dist import dist_ba, dryrun

    z = _load(inp)
    out = {}
    for tag, kw in (("a", dict(iters=12, cg_iters=40)), ("b", dict(iters=2, cg_iters=5))):
        args = [torch.as_tensor(z[f"{tag}_{k}"], device=dev)
                for k in ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")]
        R, t, X, costs = dist_ba.make_ba_step(**kw)(*args)
        out.update({f"{tag}_R": R, f"{tag}_t": t, f"{tag}_X": X, f"{tag}_costs": costs})
    f = dryrun.extract_data_parallel(z["imgs"], dev, max_keypoints=32, threshold=1e-9)
    out.update(desc=f.desc, uv=f.kp.uv, mask=f.kp.mask)
    _save(inp, rank, **out)


def block_rank(rank: int, n: int, dev, inp: str) -> None:
    """``ba_solve_blocked`` on the corridor and the orbit,
    ``ba_solve_blocked_intrinsics`` on the calibration scene, and the
    checkpointed corridor solve: uninterrupted in chunks, then stopped
    after its first chunk and resumed."""
    from sfmx_torch.dist import block_ba

    z = _load(inp)
    names = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")
    args = lambda tag: [z[f"{tag}_{k}"] for k in names]
    out = {}
    for tag, kw in (("corr", dict(iters=10, cg_iters=40)), ("orbit", dict(iters=12, cg_iters=40))):
        R, t, X, costs, stats = block_ba.ba_solve_blocked(*args(tag), device=dev, **kw)
        out.update({f"{tag}_R": R, f"{tag}_t": t, f"{tag}_X": X, f"{tag}_costs": costs,
                    f"{tag}_pts_per_device": stats["pts_per_device"],
                    f"{tag}_halo": stats["halo_fraction"]})
    R, t, X, intr, costs, _ = block_ba.ba_solve_blocked_intrinsics(
        *args("cal"), device=dev, params=("f",), iters=15, cg_iters=40)
    out.update(cal_R=R, cal_t=t, cal_X=X, cal_intr=intr, cal_costs=costs)
    root = Path(inp).parent
    ck = dict(cg_iters=30, ckpt_every=4, device=dev)
    R, t, X, costs, _ = block_ba.ba_solve_blocked(*args("ck"), iters=8,
                                                  ckpt_path=root / "a.ckpt.npz", **ck)
    out.update(cka_R=R, cka_t=t, cka_X=X, cka_costs=costs)
    block_ba.ba_solve_blocked(*args("ck"), iters=4, ckpt_path=root / "b.ckpt.npz", **ck)
    with np.load(root / "b.ckpt.npz") as c:
        out.update(ckb_mid_lam=c["lam"], ckb_mid_it=c["it"])
    R, t, X, costs, _ = block_ba.ba_solve_blocked(*args("ck"), iters=8,
                                                  ckpt_path=root / "b.ckpt.npz", **ck)
    out.update(ckb_R=R, ckb_t=t, ckb_X=X, ckb_costs=costs)
    _save(inp, rank, **out)


def sharded_rank(rank: int, n: int, dev, inp: str) -> None:
    """``localize_batch_sharded`` of the queries against this rank's shard
    of the map, with the noise given; and the padded shard's shape."""
    from sfmx_torch.localize.localize import LocalizationMap
    from sfmx_torch.localize.sharded import localize_batch_sharded, shard_localization_map

    z = _load(inp)
    lmap = LocalizationMap.from_numpy({k[4:]: v for k, v in z.items() if k.startswith("map_")},
                                      "cpu")
    shard = shard_localization_map(lmap, rank, n, dev)
    T = lambda k: torch.as_tensor(z[k], device=dev)
    res, idx = localize_batch_sharded(shard, T("q_desc"), T("q_uv"), T("q_mask"), T("intr"),
                                      gumbel=T("gumbel"), k_hypotheses=int(z["k_hyp"]))
    _save(inp, rank, idx=idx, n_alive=shard.lm_alive.sum(), p_local=shard.X.shape[0],
          **{f"res_{k}": v for k, v in res._asdict().items()})


def multicard_rank(rank: int, n: int, dev, in_dir: str, phases: tuple) -> None:
    """``sfmx_torch.dist.worlds.world``: the four-card run's phases, here on
    one thread per rank."""
    from sfmx_torch.dist import worlds

    worlds.world(rank, n, dev, in_dir, phases)


def apart_rank(rank: int, n: int, dev, inp: str) -> None:
    """A rank started on its own (``python -m sfmx_torch.dist.mesh`` over
    ``tcp://``): the observation-sharded LM on the two-process bootstrap
    problem (``b_*``) and ``ba_solve_blocked`` on the corridor (``c_*``)."""
    from sfmx_torch.dist import block_ba, dist_ba

    z = _load(inp)
    names = ("intr", "k_idx", "R", "t", "X", "cam_id", "pt_id", "uv", "w", "fixed")
    b = [torch.as_tensor(z[f"b_{k}"], device=dev) for k in names]
    R, t, X, costs = dist_ba.make_ba_step(iters=2, cg_iters=5)(*b)
    out = {"b_R": R, "b_t": t, "b_X": X, "b_costs": costs,
           "world_size": torch.distributed.get_world_size(),
           "group_rank": torch.distributed.get_rank()}
    R, t, X, costs, stats = block_ba.ba_solve_blocked(*(z[f"c_{k}"] for k in names), device=dev,
                                                      iters=6, cg_iters=20)
    out.update(c_R=R, c_t=t, c_X=X, c_costs=costs, c_halo=stats["halo_fraction"])
    _save(inp, rank, **out)
