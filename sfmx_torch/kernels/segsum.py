"""K6-K8: the fused bundle-adjustment kernels on Hopper (port of
``sfmx.kernels.segsum``).

The dense point-major layout is the reference's: observations sorted by
point live in (tp, P) slots, so every point-side sum of BA (y = W^T x, V,
b_p, the cost) is a loop over a point's slots with no scatter, and the W
blocks are written once per LM iteration by the assembly (K7) in the
(tp*18, P) layout the CG matvec (K6) streams.  The port drops what the TPU
shaped: the point axis is not padded to a tile multiple nor the camera axis
to 128, vectors carry 6/3/9 rows instead of 8/8/16, and there is no camera
window.  It adds the per-point slot count, a camera-sorted list of the
dense slots (``cam_slot``, ``cam_ptr``) and its inverse (``slot_pos``:
every dense slot's place in that list), through which the point passes of
K6 and K7 write a camera-major scratch that their second launches stream
(see ``sfmx_torch/csrc/ba.cu``).

For CUDA tensors each wrapper launches the hand-written kernels in
``sfmx_torch/csrc/ba.cu`` or raises; the ``*_plain`` functions are their
plain PyTorch versions, which the wrappers run for CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

LIB = "ba"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class DenseObs(NamedTuple):
    """Point-major observation layout, built once per solve."""

    camp: torch.Tensor      # (tp, P) int32 camera of each slot (pad: a real camera, W zero)
    rows: torch.Tensor      # (tp, P) int32 obs row of each slot (pad: O sentinel)
    cnt: torch.Tensor       # (P,) int32 real slots of each point
    cam_ptr: torch.Tensor   # (C+1,) int32 offsets into cam_slot
    cam_slot: torch.Tensor  # (n_dense,) int32 flat slot ids j*P + p, sorted by camera
    slot_pos: torch.Tensor  # (tp, P) int32 place of each dense slot in cam_slot (pad: -1)


def build_dense_obs(pt_id: torch.Tensor, cam_id: torch.Tensor, n_pts: int, n_cams: int,
                    tp_cap: int) -> DenseObs:
    """Invert a PT-SORTED obs table into (tp, P) point-major slots.

    The first ``tp_cap`` observations of each point get a slot; the rest
    (overflow of longer tracks) are left out and must ride
    ``lm.ba_solve``'s overflow chain.  Pad slots are filled with the camera
    of the point's first observation (the nearest following observation for
    an observation-free point), so a pad slot always projects through a real
    camera and its zero weight never meets a NaN.
    """
    O = pt_id.shape[0]
    dev = pt_id.device
    pt = pt_id.long()
    start = torch.searchsorted(pt, torch.arange(n_pts, device=dev))
    slot = torch.arange(O, device=dev) - start[pt]
    keep = slot < tp_cap
    rows = torch.full((tp_cap, n_pts), O, dtype=torch.int32, device=dev)
    rows[slot[keep], pt[keep]] = torch.arange(O, dtype=torch.int32, device=dev)[keep]
    fill = cam_id[torch.clamp(start, 0, max(O - 1, 0))].to(torch.int32)
    camp = fill[None, :].repeat(tp_cap, 1)
    camp[slot[keep], pt[keep]] = cam_id[keep].to(torch.int32)
    valid = rows < O
    cnt = valid.sum(dim=0).to(torch.int32)
    # camera-major list of the dense slots: stable sort, so a camera's
    # slots keep their (slot, point) order and its sum is reproducible
    flat = torch.nonzero(valid.reshape(-1))[:, 0]
    cams = camp.reshape(-1)[flat].long()
    order = torch.argsort(cams, stable=True)
    cam_slot = flat[order].to(torch.int32)
    cam_ptr = torch.searchsorted(cams[order], torch.arange(n_cams + 1, device=dev)).to(torch.int32)
    slot_pos = torch.full((tp_cap * n_pts,), -1, dtype=torch.int32, device=dev)
    slot_pos[flat[order]] = torch.arange(flat.shape[0], dtype=torch.int32, device=dev)
    return DenseObs(camp, rows, cnt, cam_ptr, cam_slot, slot_pos.reshape(tp_cap, n_pts))


def pack_rows(dense: DenseObs, vals: torch.Tensor) -> torch.Tensor:
    """(O, width) per-obs values -> (tp*width, P) in the slot layout (pads 0)."""
    tp, P = dense.rows.shape
    width = vals.shape[1]
    v = torch.cat([vals, vals.new_zeros((1, width))], dim=0)
    g = v[dense.rows.reshape(-1).long()].reshape(tp, P, width)
    return g.permute(0, 2, 1).reshape(tp * width, P).contiguous()


def build_cam_table(intr, k_idx, R, t) -> torch.Tensor:
    """(19, C) per-camera parameter table: rows 0-8 R flat, 9-11 t,
    12-18 intr[k_idx] (fx fy cx cy k1 k2 k3)."""
    C = R.shape[0]
    return torch.cat([R.reshape(C, 9), t, intr[k_idx.long()]], dim=1).T.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# The projection model shared by the plain K7/K8 and lm._jacobians_planes
# ---------------------------------------------------------------------------


def _proj_math(g, x0, x1, x2, u, v):
    """Focal-normalized residual from camera rows g (19 tensors: R flat, t,
    intrinsics) and point components; returns (ru, rv, aux) with the
    intermediates the Jacobians need."""
    fx, fy, cx, cy = g[12], g[13], g[14], g[15]
    k1, k2, k3 = g[16], g[17], g[18]
    fm = 0.5 * (fx + fy)
    s0 = g[0] * x0 + g[1] * x1 + g[2] * x2
    s1 = g[3] * x0 + g[4] * x1 + g[5] * x2
    s2 = g[6] * x0 + g[7] * x1 + g[8] * x2
    xc, yc, zc = s0 + g[9], s1 + g[10], s2 + g[11]
    zs = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    iz = 1.0 / zs
    xn, yn = xc * iz, yc * iz
    r2 = xn * xn + yn * yn
    fd = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    fp = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
    ru = (fx * (xn * fd) + cx - u) / fm
    rv = (fy * (yn * fd) + cy - v) / fm
    return ru, rv, (fx, fy, fm, fd, fp, iz, xn, yn, s0, s1, s2)


def _jac_rows(g, aux):
    """Analytic Jacobian components: Ju/Jv (6 each, wrt the camera tangent),
    Pu/Pv (3 each, wrt the point)."""
    fx, fy, fm, fd, fp, iz, xn, yn, s0, s1, s2 = aux
    gx, gy = fx / fm, fy / fm
    A00 = gx * (fd + 2.0 * xn * xn * fp)
    A01 = gx * (2.0 * xn * yn * fp)
    A10 = gy * (2.0 * xn * yn * fp)
    A11 = gy * (fd + 2.0 * yn * yn * fp)
    B00, B01 = A00 * iz, A01 * iz
    B02 = -(A00 * xn + A01 * yn) * iz
    B10, B11 = A10 * iz, A11 * iz
    B12 = -(A10 * xn + A11 * yn) * iz
    Ju = [-B01 * s2 + B02 * s1, B00 * s2 - B02 * s0, -B00 * s1 + B01 * s0, B00, B01, B02]
    Jv = [-B11 * s2 + B12 * s1, B10 * s2 - B12 * s0, -B10 * s1 + B11 * s0, B10, B11, B12]
    Pu = [B00 * g[k] + B01 * g[3 + k] + B02 * g[6 + k] for k in range(3)]
    Pv = [B10 * g[k] + B11 * g[3 + k] + B12 * g[6 + k] for k in range(3)]
    return Ju, Jv, Pu, Pv


def _huber_rows(ru, rv, delta):
    """(rho, IRLS weight) of the Huber loss from residual components."""
    r2 = ru * ru + rv * rv
    rn = torch.sqrt(torch.clamp(r2, min=1e-20))
    small = rn <= delta
    rho = torch.where(small, r2, delta * (2.0 * rn - delta))
    wh = torch.where(small, torch.ones_like(rn), delta / rn)
    return rho, wh


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def schur_cross_matvec_plain(Wp, camp, Vinv9, x6, bias3=None):
    """Plain version of K6 (same arguments and layout as the kernel)."""
    tp, P = camp.shape
    W = Wp.reshape(tp, 6, 3, P)
    xg = x6[:, camp.long()]                                      # (6, tp, P)
    y = torch.einsum("jakp,ajp->kp", W, xg)
    if bias3 is not None:
        y = y + bias3
    vy = torch.einsum("klp,lp->kp", Vinv9.reshape(3, 3, P), y)
    za = torch.einsum("jakp,kp->ajp", W, vy).reshape(6, tp * P)
    z = torch.zeros_like(x6).index_add_(1, camp.reshape(-1).long(), za)
    return z, vy


SLOT_GROUPS = 16   # threads that share a point's slots in K6's point pass


def schur_cross_matvec_two_pass(Wp, dense: DenseObs, Vinv9, x6, bias3=None,
                                groups: int = SLOT_GROUPS):
    """Plain-PyTorch mirror of the K6 kernel's decomposition, for tests.
    Point pass: group g of ``groups`` sums slots g, g+groups, ... of each
    point, the partial sums meet in group order after the bias, vy = V^-1 y,
    and every real slot's W vy goes to its place ``slot_pos`` in a
    camera-major scratch.  Camera pass: each camera sums its run of it."""
    tp, P = dense.camp.shape
    W = Wp.reshape(tp, 6, 3, P)
    real = torch.arange(tp, device=Wp.device)[:, None] < dense.cnt[None, :]
    terms = torch.einsum("jakp,ajp->jkp", W, x6[:, dense.camp.long()]) * real[:, None, :]
    y = torch.zeros_like(Vinv9[:3]) if bias3 is None else bias3.clone()
    for g in range(groups):
        y = y + terms[g::groups].sum(dim=0)
    vy = torch.einsum("klp,lp->kp", Vinv9.reshape(3, 3, P), y)
    n_dense = dense.cam_slot.shape[0]
    zo = torch.zeros((6, n_dense), dtype=Wp.dtype, device=Wp.device)
    zo[:, dense.slot_pos[real].long()] = torch.einsum("jakp,kp->ajp", W, vy)[:, real]
    runs = (dense.cam_ptr[1:] - dense.cam_ptr[:-1]).long()
    cam_of = torch.repeat_interleave(torch.arange(runs.shape[0], device=Wp.device), runs)
    return torch.zeros_like(x6).index_add_(1, cam_of, zo), vy


def ba_assemble_fused_plain(cam19, camp, uvw, x3, delta):
    """Plain version of K7: returns (U (C,6,6), b_c (C,6), v13 (13,P),
    Wp (tp*18,P))."""
    tp, P = camp.shape
    C = cam19.shape[1]
    g = list(cam19[:, camp.long()])                              # 19 x (tp, P)
    uvw = uvw.reshape(tp, 3, P)
    u, v, wv = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    ru, rv, aux = _proj_math(g, x3[0], x3[1], x3[2], u, v)
    rho, wh = _huber_rows(ru, rv, delta)
    cost = torch.sum(0.5 * rho * wv, dim=0)
    wh = wh * wv
    Ju, Jv, Pu, Pv = _jac_rows(g, aux)
    Wp = torch.stack([wh * (Ju[a] * Pu[k] + Jv[a] * Pv[k])
                      for a in range(6) for k in range(3)], dim=1).reshape(tp * 18, P)
    v9 = [torch.sum(wh * (Pu[k] * Pu[l] + Pv[k] * Pv[l]), dim=0)
          for k in range(3) for l in range(3)]
    bp = [-torch.sum(wh * (Pu[k] * ru + Pv[k] * rv), dim=0) for k in range(3)]
    v13 = torch.stack(v9 + bp + [cost], dim=0)
    zc = torch.stack([wh * (Ju[a] * Ju[b] + Jv[a] * Jv[b]) for a in range(6) for b in range(6)]
                     + [-wh * (Ju[a] * ru + Jv[a] * rv) for a in range(6)], dim=-1)
    ub = torch.zeros((C, 42), dtype=zc.dtype, device=zc.device).index_add_(
        0, camp.reshape(-1).long(), zc.reshape(tp * P, 42))
    return ub[:, :36].reshape(C, 6, 6), ub[:, 36:], v13, Wp


def ba_cost_fused_plain(cam19s, camp, uvw, x3s, delta, nc: int):
    """Plain version of K8: (nc,) robust costs."""
    tp, P = camp.shape
    uvw = uvw.reshape(tp, 3, P)
    out = []
    for c in range(nc):
        g = list(cam19s[19 * c:19 * c + 19][:, camp.long()])
        ru, rv, _ = _proj_math(g, x3s[3 * c], x3s[3 * c + 1], x3s[3 * c + 2], uvw[:, 0], uvw[:, 1])
        rho, _ = _huber_rows(ru, rv, delta)
        out.append(torch.sum(torch.sum(0.5 * rho * uvw[:, 2], dim=0)))
    return torch.stack(out)


COST_LANES = 32              # points per block of K8's point pass
COST_MAX_GROUPS = 16         # threads that may share a point's slots in K8's point pass
COST_FILL_THREADS = 65536    # K8 doubles its slot groups until its grid holds this many threads
COST_CAM_SMEM_BYTES = 48 * 1024   # K8 stages the camera tables up to this size

ASM_LANES = 32               # points per block of K7's point pass
ASM_MAX_GROUPS = 16          # threads that may share a point's slots in K7's point pass
ASM_FILL_THREADS = 65536     # K7 doubles its slot groups until its grid holds this many threads
ASM_CAM_TERMS = 27           # camera-side terms of a slot: U's upper triangle, then b_c
ASM_ZC_STRIDE = 28           # floats a row of K7's scratch: 27 terms and a pad (float4 stores)
ASM_CAM_PHASES = 18          # rows of the scratch a camera block reads at once (512 // 28)


def _slot_groups(tp: int, P: int, lanes: int, max_groups: int, fill: int) -> int:
    n_blocks = (P + lanes - 1) // lanes
    groups = 1
    while groups < max_groups and groups < tp and lanes * groups * n_blocks < fill:
        groups *= 2
    return groups


def cost_slot_groups(tp: int, P: int) -> int:
    """K8's slot groups for a (tp, P) layout: doubled from 1 while the grid
    holds fewer than COST_FILL_THREADS threads and tp slots need more
    groups, up to COST_MAX_GROUPS (``chip_smoke.py --tune``: 16 on the
    build's 2,290 points, 4 on 20,000).  A function of the layout alone,
    so every launch on one layout, whatever its nc, sums in one order."""
    return _slot_groups(tp, P, COST_LANES, COST_MAX_GROUPS, COST_FILL_THREADS)


def assemble_slot_groups(tp: int, P: int) -> int:
    """K7's slot groups for a (tp, P) layout, by K8's rule with K7's
    constants (``chip_smoke.py --tune``).  A function of the layout alone,
    so every assembly of a solve sums V, b_p and the cost in one order."""
    return _slot_groups(tp, P, ASM_LANES, ASM_MAX_GROUPS, ASM_FILL_THREADS)


def _tree32(s: torch.Tensor) -> torch.Tensor:
    """(..., 32) -> (...): the kernels' shuffle tree (lane l adds lane l+off
    for off = 16, 8, 4, 2, 1)."""
    for off in (16, 8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    return s[..., 0]


def ba_cost_fused_grouped(cam19s, dense: DenseObs, uvw, x3s, delta: float, nc: int,
                          groups: int | None = None) -> torch.Tensor:
    """Plain-PyTorch mirror of the K8 kernel's order of sums, for tests.
    Per candidate: group g of ``groups`` (by default the kernel's
    ``cost_slot_groups``) adds slots g, g+groups, ... of a point in order; a
    point's group partials meet in group order; each block of 32 points is
    summed by the shuffle tree; in the last block, lane l adds blocks l,
    l+32, ... in order, and the tree sums the lanes."""
    tp, P = dense.camp.shape
    groups = cost_slot_groups(tp, P) if groups is None else groups
    uvw = uvw.reshape(tp, 3, P)
    real = torch.arange(tp, device=uvw.device)[:, None] < dense.cnt[None, :]
    nb = (P + COST_LANES - 1) // COST_LANES
    out = []
    for c in range(nc):
        g = list(cam19s[19 * c:19 * c + 19][:, dense.camp.long()])
        ru, rv, _ = _proj_math(g, x3s[3 * c], x3s[3 * c + 1], x3s[3 * c + 2], uvw[:, 0], uvw[:, 1])
        rho, _ = _huber_rows(ru, rv, delta)
        term = torch.where(real, 0.5 * rho * uvw[:, 2], torch.zeros_like(rho))
        point = None
        for grp in range(groups):
            acc = torch.zeros_like(term[0])
            for j in range(grp, tp, groups):
                acc = acc + term[j]
            point = acc if point is None else point + acc
        point = torch.nn.functional.pad(point, (0, nb * COST_LANES - P))
        blocks = _tree32(point.reshape(nb, COST_LANES))
        blocks = torch.nn.functional.pad(blocks, (0, -nb % 32)).reshape(-1, 32)
        lanes = torch.zeros_like(blocks[0])
        for r in range(blocks.shape[0]):
            lanes = lanes + blocks[r]
        out.append(_tree32(lanes))
    return torch.stack(out)


def assemble_cam_scratch(terms: torch.Tensor, dense: DenseObs) -> torch.Tensor:
    """(27, tp, P) per-slot camera-side terms -> the (n_dense, 27)
    camera-major scratch K7's point pass writes: row ``slot_pos`` of every
    real slot."""
    real = torch.arange(dense.camp.shape[0], device=terms.device)[:, None] < dense.cnt[None, :]
    zc = torch.zeros((dense.cam_slot.shape[0], terms.shape[0]), dtype=terms.dtype,
                     device=terms.device)
    zc[dense.slot_pos[real].long()] = terms[:, real].T
    return zc


def ba_assemble_fused_grouped(cam19, dense: DenseObs, uvw, x3, delta: float,
                              groups: int | None = None):
    """Plain-PyTorch mirror of the K7 kernel's decomposition and order of
    sums, for tests; returns what ``ba_assemble_fused_plain`` returns.
    Point pass: group g of ``groups`` (by default ``assemble_slot_groups``)
    adds the terms of slots g, g+groups, ... of a point in order, and a
    point's group partials meet in group order; every real slot's 27
    camera-side terms go to its row of the camera-major scratch
    (``assemble_cam_scratch``).  Camera pass: phase f of ASM_CAM_PHASES adds
    rows f, f+18, ... of the camera's run in order, and the phases meet in
    order."""
    tp, P = dense.camp.shape
    C = cam19.shape[1]
    groups = assemble_slot_groups(tp, P) if groups is None else groups
    g = list(cam19[:, dense.camp.long()])
    uvw = uvw.reshape(tp, 3, P)
    u, v, wv = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    ru, rv, aux = _proj_math(g, x3[0], x3[1], x3[2], u, v)
    rho, wh = _huber_rows(ru, rv, delta)
    real = torch.arange(tp, device=cam19.device)[:, None] < dense.cnt[None, :]
    cost = 0.5 * rho * wv
    wh = wh * wv
    Ju, Jv, Pu, Pv = _jac_rows(g, aux)
    Wp = torch.stack([torch.where(real, wh * (Ju[a] * Pu[k] + Jv[a] * Pv[k]), 0.0)
                      for a in range(6) for k in range(3)], dim=1).reshape(tp * 18, P)
    pt = torch.stack([wh * (Pu[k] * Pu[l] + Pv[k] * Pv[l]) for k in range(3) for l in range(3)]
                     + [-wh * (Pu[k] * ru + Pv[k] * rv) for k in range(3)] + [cost])
    pt = torch.where(real, pt, torch.zeros_like(pt))                # (13, tp, P)
    v13 = None
    for grp in range(groups):
        acc = torch.zeros_like(pt[:, 0])
        for j in range(grp, tp, groups):
            acc = acc + pt[:, j]
        v13 = acc if v13 is None else v13 + acc
    terms = torch.stack([wh * (Ju[a] * Ju[b] + Jv[a] * Jv[b]) for a in range(6)
                         for b in range(a, 6)] + [-wh * (Ju[a] * ru + Jv[a] * rv)
                                                  for a in range(6)])
    zc = assemble_cam_scratch(terms, dense)
    runs = (dense.cam_ptr[1:] - dense.cam_ptr[:-1]).long()
    cam_of = torch.repeat_interleave(torch.arange(C, device=cam19.device), runs)
    at = torch.arange(zc.shape[0], device=cam19.device) - dense.cam_ptr[:-1].long()[cam_of]
    part = torch.zeros((C * ASM_CAM_PHASES, ASM_CAM_TERMS), dtype=zc.dtype, device=zc.device)
    part.index_add_(0, cam_of * ASM_CAM_PHASES + at % ASM_CAM_PHASES, zc)
    part = part.reshape(C, ASM_CAM_PHASES, ASM_CAM_TERMS)
    cam = part[:, 0]
    for f in range(1, ASM_CAM_PHASES):
        cam = cam + part[:, f]
    iu = torch.triu_indices(6, 6)
    U = torch.zeros((C, 6, 6), dtype=cam.dtype, device=cam.device)
    U[:, iu[0], iu[1]] = cam[:, :21]
    U[:, iu[1], iu[0]] = cam[:, :21]
    return U, cam[:, 21:].contiguous(), v13, Wp


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.ba_schur_matvec.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        lib.ba_assemble.argtypes = [_P] * 6 + [_F] + [_P] * 6 + [_I] * 4 + [_P]
        lib.ba_cost.argtypes = [_P] * 5 + [_F] + [_P] * 3 + [_I] * 5 + [ctypes.c_bool, _P]
        for fn in (lib.ba_schur_matvec, lib.ba_assemble, lib.ba_cost, lib.ba_max_candidates):
            fn.restype = _I
        lib.ba_error_string.argtypes = [_I]
        lib.ba_error_string.restype = ctypes.c_char_p
        lib.max_nc = lib.ba_max_candidates()
        lib._sfmx_typed = True
    return lib


def _check(name: str, dev, **tensors):
    """Every tensor on ``dev`` (CUDA), of its dtype and shape, contiguous."""
    for key, (x, dtype, shape) in tensors.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {key} must be on {dev} (CUDA), got {x.device}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def _all_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors if x is not None)


def _raise(name: str, lib, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: {lib.ba_error_string(err).decode()} ({err})")


class SchurMatvec:
    """K6 bound to one system: ``Wp``, the layout and ``Vinv9`` are checked
    once here, and every call checks only its vectors.  The PCG loop calls
    one of these 32 times per LM iteration (``schur.SchurSystemD``).

    On CUDA tensors a call launches the kernels or raises; on CPU tensors it
    runs the plain version.  The camera-major scratch and the two outputs
    are allocated once: a call returns THIS OBJECT'S z6 and vy3, which its
    next call overwrites (calls on one stream are ordered).  The solver
    consumes them at once; a caller that keeps them clones them, and the
    one-shot ``schur_cross_matvec`` hands out fresh ones.  Allocating two
    tensors per call cost a third of the call's host time, which is what a
    CG step waits for (``chip_smoke.py --tune`` probes it).
    """

    def __init__(self, Wp, dense: DenseObs, Vinv9):
        self.Wp, self.dense, self.Vinv9 = Wp, dense, Vinv9
        self.tp, self.P = dense.camp.shape
        self.C = dense.cam_ptr.shape[0] - 1
        self.cpu = _all_cpu(Wp, Vinv9, *dense)
        if self.cpu:
            return
        tp, P, C = self.tp, self.P, self.C
        self.dev = dev = Wp.device
        f32, i32 = torch.float32, torch.int32
        self.n_dense = dense.cam_slot.shape[0]
        _check("schur_cross_matvec", dev, Wp=(Wp, f32, (tp * 18, P)),
               camp=(dense.camp, i32, (tp, P)), cnt=(dense.cnt, i32, (P,)),
               slot_pos=(dense.slot_pos, i32, (tp, P)), Vinv9=(Vinv9, f32, (9, P)),
               cam_ptr=(dense.cam_ptr, i32, (C + 1,)))
        self.lib = _lib()
        self.zo = torch.empty((6, self.n_dense), dtype=f32, device=dev)
        self.vy = torch.empty((3, P), dtype=f32, device=dev)
        self.z = torch.empty((6, C), dtype=f32, device=dev)
        self.static = (Wp.data_ptr(), dense.camp.data_ptr(), dense.cnt.data_ptr(),
                       dense.slot_pos.data_ptr(), Vinv9.data_ptr())
        self.tail = (dense.cam_ptr.data_ptr(), self.zo.data_ptr(), self.vy.data_ptr(),
                     self.z.data_ptr(), tp, P, C, self.n_dense)

    def __call__(self, x6, bias3=None, groups: int = SLOT_GROUPS):
        if self.cpu and _all_cpu(x6, bias3):
            return schur_cross_matvec_plain(self.Wp, self.dense.camp, self.Vinv9, x6, bias3)
        if self.cpu:
            raise ValueError("schur_cross_matvec: the system is on the CPU, the vectors are not")
        P, C, dev = self.P, self.C, self.dev
        f32 = torch.float32
        for key, x, shape in (("x6", x6, (6, C)), ("bias3", bias3, (3, P))):
            if x is not None and (x.device != dev or x.dtype != f32 or tuple(x.shape) != shape
                                  or not x.is_contiguous()):
                raise ValueError(f"schur_cross_matvec: {key} must be contiguous float32 {shape} on "
                                 f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        err = self.lib.ba_schur_matvec(*self.static, x6.data_ptr(),
                                       None if bias3 is None else bias3.data_ptr(), *self.tail,
                                       groups, _build.stream_ptr(dev))
        _raise("schur_cross_matvec", self.lib, err)
        _build.LAUNCHES.add("schur_cross_matvec", 2)      # point pass, camera pass
        return self.z, self.vy


def schur_cross_matvec(Wp, dense: DenseObs, Vinv9, x6, bias3=None):
    """K6, the fused cross-term pass of the Schur system:
    y = sum_slots W^T x[cam] + bias;  vy = V^-1 y;  z[cam] = sum W vy.

    Wp (tp*18, P) f32 point-major W blocks (pad slots zero), Vinv9 (9, P)
    damped inverse point blocks, x6 (6, C) camera-side vector, bias3
    optional (3, P).  Returns (z6 (6, C), vy3 (3, P)).  The bias makes one
    kernel serve the CG matvec (no bias), the Schur rhs (x = 0, bias = b_p)
    and back-substitution (x = dx_c, bias = -b_p, vy = -dx_p).  A caller
    with many vectors for one system keeps the ``SchurMatvec``.
    """
    return SchurMatvec(Wp, dense, Vinv9)(x6, bias3)


class AssembleFused:
    """K7 bound to one layout and its packed observations: ``dense`` and
    ``uvw`` are checked and the camera-major scratch allocated once here,
    and every call checks only the camera table and the points.
    ``lm.ba_solve`` binds one per solve and calls it once per LM iteration
    (through ``schur.reduce_system_fused``).

    On CUDA tensors a call launches the two kernels or raises; on CPU
    tensors it runs the plain version.  A call returns FRESH outputs: the
    Schur system binds its ``Wp`` for the whole LM iteration, so reusing one
    buffer across iterations would be a trap.  The scratch is this object's,
    so its calls run on one stream, in order.
    """

    def __init__(self, dense: DenseObs, uvw):
        self.dense, self.uvw = dense, uvw
        self.tp, self.P = tp, P = dense.camp.shape
        self.C = C = dense.cam_ptr.shape[0] - 1
        self.cpu = _all_cpu(uvw, *dense)
        if self.cpu:
            return
        self.dev = dev = uvw.device
        i32 = torch.int32
        _check("ba_assemble_fused", dev, camp=(dense.camp, i32, (tp, P)),
               cnt=(dense.cnt, i32, (P,)), slot_pos=(dense.slot_pos, i32, (tp, P)),
               cam_ptr=(dense.cam_ptr, i32, (C + 1,)), uvw=(uvw, torch.float32, (tp * 3, P)))
        self.lib = _lib()
        self.groups = assemble_slot_groups(tp, P)
        self.zc = torch.empty((dense.cam_slot.shape[0], ASM_ZC_STRIDE), dtype=torch.float32,
                              device=dev)
        self.static = (dense.camp.data_ptr(), dense.cnt.data_ptr(), dense.slot_pos.data_ptr(),
                       uvw.data_ptr())

    def __call__(self, cam19, x3, delta: float, groups: int | None = None):
        if self.cpu and _all_cpu(cam19, x3):
            return ba_assemble_fused_plain(cam19, self.dense.camp, self.uvw, x3, delta)
        if self.cpu:
            raise ValueError("ba_assemble_fused: the layout is on the CPU, the parameters are not")
        tp, P, C, dev = self.tp, self.P, self.C, self.dev
        f32 = torch.float32
        for key, x, shape in (("cam19", cam19, (19, C)), ("x3", x3, (3, P))):
            if (x.device != dev or x.dtype != f32 or tuple(x.shape) != shape
                    or not x.is_contiguous()):
                raise ValueError(f"ba_assemble_fused: {key} must be contiguous float32 {shape} on "
                                 f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        v13 = torch.empty((13, P), dtype=f32, device=dev)
        Wp = torch.empty((tp * 18, P), dtype=f32, device=dev)
        U = torch.empty((C, 6, 6), dtype=f32, device=dev)
        bc = torch.empty((C, 6), dtype=f32, device=dev)
        err = self.lib.ba_assemble(cam19.data_ptr(), *self.static, x3.data_ptr(), float(delta),
                                   self.dense.cam_ptr.data_ptr(), self.zc.data_ptr(),
                                   v13.data_ptr(), Wp.data_ptr(), U.data_ptr(), bc.data_ptr(),
                                   tp, P, C, self.groups if groups is None else groups,
                                   _build.stream_ptr(dev))
        _raise("ba_assemble_fused", self.lib, err)
        _build.LAUNCHES.add("ba_assemble_fused", 2)       # point pass, camera pass
        return U, bc, v13, Wp


def ba_assemble_fused(cam19, dense: DenseObs, uvw, x3, delta: float,
                      groups: int | None = None):
    """K7, one LM iteration's assembly: residuals, analytic Jacobians, Huber
    weights, W blocks, per-point V / b_p / cost, per-camera U / b_c.

    cam19 (19, C) (``build_cam_table``), uvw (tp*3, P) packed [u, v, w_valid]
    per slot (``pack_rows``, once per solve), x3 (3, P) points, delta the
    Huber threshold in normalized units.  Returns (U (C,6,6), b_c (C,6),
    v13 (13, P): rows 0-8 V9, 9-11 b_p, 12 per-point cost; Wp (tp*18, P)).
    A caller with many assemblies on one layout keeps the ``AssembleFused``.

    ``groups`` (1..16 threads share a point's slots; by default
    ``assemble_slot_groups`` of the layout) is the kernel's shape: a sweep
    parameter.  The results depend on it in their last bits.
    """
    if _all_cpu(cam19, dense.camp, uvw, x3):
        return ba_assemble_fused_plain(cam19, dense.camp, uvw, x3, delta)
    return AssembleFused(dense, uvw)(cam19, x3, delta, groups)


class CostFused:
    """K8 bound to one layout and its packed observations: ``dense`` and
    ``uvw`` are checked once here, and every call checks only its
    candidates.  ``lm.ba_solve`` binds one per solve and calls it once per
    LM iteration (and once for the first cost).

    On CUDA tensors a call launches the kernel or raises; on CPU tensors it
    runs the plain version.  A call returns a fresh (nc,) tensor of costs.
    The kernel's block partials and its ticket (a counter the launch leaves
    at zero) are this object's, so its calls run on one stream, in order.
    """

    def __init__(self, dense: DenseObs, uvw):
        self.dense, self.uvw = dense, uvw
        self.tp, self.P = tp, P = dense.camp.shape
        self.cpu = _all_cpu(dense.camp, dense.cnt, uvw)
        if self.cpu:
            return
        self.dev = dev = uvw.device
        _check("ba_cost_fused", dev, camp=(dense.camp, torch.int32, (tp, P)),
               cnt=(dense.cnt, torch.int32, (P,)), uvw=(uvw, torch.float32, (tp * 3, P)))
        self.lib = _lib()
        self.groups = cost_slot_groups(tp, P)
        n_blocks = (P + COST_LANES - 1) // COST_LANES
        self.part = torch.empty((self.lib.max_nc * n_blocks,), dtype=torch.float32, device=dev)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.static = (dense.camp.data_ptr(), dense.cnt.data_ptr(), uvw.data_ptr())

    def __call__(self, cam19s, x3s, delta: float, nc: int, groups: int | None = None,
                 stage: bool | None = None):
        if self.cpu and _all_cpu(cam19s, x3s):
            return ba_cost_fused_plain(cam19s, self.dense.camp, self.uvw, x3s, delta, nc)
        if self.cpu:
            raise ValueError("ba_cost_fused: the layout is on the CPU, the candidates are not")
        P, dev = self.P, self.dev
        C = cam19s.shape[1]
        for key, x, shape in (("cam19s", cam19s, (19 * nc, C)), ("x3s", x3s, (3 * nc, P))):
            if (x.device != dev or x.dtype != torch.float32 or x.shape != shape
                    or not x.is_contiguous()):
                raise ValueError(f"ba_cost_fused: {key} must be contiguous float32 {shape} on "
                                 f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not 0 < nc <= self.lib.max_nc:
            raise ValueError(f"ba_cost_fused: nc must be in 1..{self.lib.max_nc}, got {nc}")
        if stage is None:
            stage = 19 * nc * C * 4 <= COST_CAM_SMEM_BYTES
        out = torch.empty((nc,), dtype=torch.float32, device=dev)
        err = self.lib.ba_cost(cam19s.data_ptr(), *self.static, x3s.data_ptr(), float(delta),
                               out.data_ptr(), self.part.data_ptr(), self.ticket.data_ptr(),
                               self.tp, P, C, nc, self.groups if groups is None else groups,
                               stage, _build.stream_ptr(dev))
        _raise("ba_cost_fused", self.lib, err)
        _build.LAUNCHES.add("ba_cost_fused", 1)
        return out


def ba_cost_fused(cam19s, dense: DenseObs, uvw, x3s, delta: float, nc: int,
                  groups: int | None = None, stage: bool | None = None):
    """K8: the robust cost of nc parameter candidates in one pass over the
    packed observations.  cam19s (19*nc, C) stacked camera tables, x3s
    (3*nc, P) stacked points.  Returns (nc,) costs.  A caller with many
    candidate sets for one layout keeps the ``CostFused``.

    ``groups`` (1..16 threads share a point's slots; by default
    ``cost_slot_groups`` of the layout) and ``stage`` (camera tables in
    shared memory; by default when they take at most COST_CAM_SMEM_BYTES)
    are the kernel's shape: sweep parameters.  A candidate's cost depends on
    ``groups`` but not on ``stage``, on nc or on its place among the
    candidates."""
    return CostFused(dense, uvw)(cam19s, x3s, delta, nc, groups, stage)
