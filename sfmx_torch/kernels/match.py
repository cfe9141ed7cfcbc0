"""K4: streaming top-2 descriptor matching on Hopper (port of
``sfmx.kernels.pallas_match``).

``match_top2`` matches every query row against the whole landmark pool and
keeps only the best score, its index and the second-best score, so the
(Ka,Kb) similarity matrix never exists.  Inputs are rounded to bf16 and the
products accumulate in f32, as in the Pallas kernel.  For a CUDA tensor it
launches the hand-written kernel in ``sfmx_torch/csrc/match_top2.cu``;
``match_top2_plain`` is its plain PyTorch version, which the wrapper runs
for CPU tensors only.  ``match_float_streaming`` adds masks, zero padding
and the Lowe ratio test on top.

Where the query rows alone do not fill the card, the kernel splits the
landmark loop into contiguous, tile-aligned ranges and a second launch
merges the ranges' partial results in order (``split_plan``);
``match_top2_split_plain`` mirrors that decomposition in plain PyTorch for
the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.masking import round_up, topk_lowest_index
from . import _build
from .matching import MatchResult

LIB = "match_top2"
NEG = -1e30
D_MAX = 128          # the kernel's descriptor width; narrower rows are zero-padded
_P, _I = ctypes.c_void_p, ctypes.c_int

# The kernel's block of query rows and its landmark tile (``mt_block_rows``,
# ``mt_tile_rows`` of the library), and the blocks the card takes at once:
# one per SM of an H100.  ``split_plan`` works from these alone, so that it
# says the same here and where there is no card.
BLOCK_ROWS = 128
TILE_ROWS = 128
SPLIT_TARGET_BLOCKS = 132


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB)
    if not getattr(lib, "_sfmx_typed", False):
        lib.mt_match_top2.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.mt_match_top2.restype = _I
        lib.mt_error_string.argtypes = [_I]
        lib.mt_error_string.restype = ctypes.c_char_p
        lib.mt_tile_rows.restype = _I
        lib.mt_stages.restype = _I
        lib.mt_block_rows.restype = _I
        if (lib.mt_tile_rows(), lib.mt_block_rows()) != (TILE_ROWS, BLOCK_ROWS):
            raise RuntimeError(f"match_top2.cu was built for tiles of {lib.mt_tile_rows()} and "
                               f"blocks of {lib.mt_block_rows()} rows; match.py plans for "
                               f"{TILE_ROWS} and {BLOCK_ROWS}")
        lib._sfmx_typed = True
    return lib


def match_top2_plain(desc_a: torch.Tensor, desc_b: torch.Tensor, *,
                     max_elems: int = 1 << 28):
    """Plain version of K4: (s1, i1, s2), each (Ka,).

    The bf16-rounded inputs go through an f32 matmul (with TF32 off, the
    products of bf16 values are exact), one landmark chunk at a time with a
    running top-2, so no more than ``max_elems`` scores exist at once.  The
    merge follows the Pallas kernel: a later chunk wins only on a strictly
    higher score, so the lowest index keeps a tie.
    """
    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    a = desc_a.to(torch.bfloat16).to(torch.float32)
    b = desc_b.to(torch.bfloat16).to(torch.float32)
    dev = desc_a.device
    s1 = torch.full((Ka,), NEG, dtype=torch.float32, device=dev)
    s2 = torch.full((Ka,), NEG, dtype=torch.float32, device=dev)
    i1 = torch.zeros((Ka,), dtype=torch.int32, device=dev)
    chunk = max(1, min(Kb, max_elems // max(Ka, 1)))
    for j0 in range(0, Kb, chunk):
        sim = a @ b[j0:j0 + chunk].T                        # (Ka, chunk)
        a1 = torch.argmax(sim, dim=1, keepdim=True)          # first max
        t1 = torch.gather(sim, 1, a1)[:, 0]
        t2 = torch.amax(sim.scatter_(1, a1, NEG), dim=1)     # excludes only a1
        take = t1 > s1
        s2 = torch.maximum(torch.minimum(s1, t1), torch.maximum(s2, t2))
        i1 = torch.where(take, (a1[:, 0] + j0).to(torch.int32), i1)
        s1 = torch.maximum(s1, t1)
    return s1, i1, s2


def split_plan(Ka: int, Kb: int, splits: int | None = None, *,
               tile_rows: int = TILE_ROWS) -> tuple[int, int]:
    """(splits, landmark tiles per split) of one K4 call.  With ``splits``
    None: 1 where the row blocks fill the card, else as many as bring the
    blocks to about one per SM.  A requested count shrinks to the most that
    leaves no range empty; every range but the last has the same tiles."""
    tiles = max(1, Kb // tile_rows)
    if splits is None:
        splits = SPLIT_TARGET_BLOCKS // max(1, -(-Ka // BLOCK_ROWS))
    per = -(-tiles // max(1, min(splits, tiles)))
    return -(-tiles // per), per


def match_top2_launches(Ka: int, Kb: int, splits: int | None = None) -> int:
    """CUDA kernels one ``match_top2`` call launches on the card: the
    matcher, and the merge of the splits where there are several."""
    if Ka == 0:
        return 0
    return 1 if split_plan(Ka, Kb, splits)[0] == 1 else 2


def merge_top2(x, o):
    """Merge two top-2 states (s1, i1, s2) over disjoint columns by the
    kernel's rule: ``o`` wins on a strictly greater best or on an equal best
    with the lower index; the second is the larger of the loser's best and
    both seconds."""
    (x1, xi, x2), (o1, oi, o2) = x, o
    take = (o1 > x1) | ((o1 == x1) & (oi < xi))
    s2 = torch.maximum(torch.minimum(x1, o1), torch.maximum(x2, o2))
    return torch.where(take, o1, x1), torch.where(take, oi, xi), s2


def match_top2_split_plain(desc_a: torch.Tensor, desc_b: torch.Tensor, splits: int, *,
                           tile_rows: int = TILE_ROWS):
    """Plain-PyTorch mirror of the kernel's split of the landmark loop, for
    tests: every range of ``split_plan`` through ``match_top2_plain`` on its
    own (its indices moved to the pool's), then the ranges' partial results
    merged in order with ``merge_top2``."""
    n, per = split_plan(desc_a.shape[0], desc_b.shape[0], splits, tile_rows=tile_rows)
    out = None
    for s in range(n):
        j0 = s * per * tile_rows
        s1, i1, s2 = match_top2_plain(desc_a, desc_b[j0:j0 + per * tile_rows])
        part = (s1, i1 + j0, s2)
        out = part if out is None else merge_top2(out, part)
    return out


def _match_top2_cuda(a16: torch.Tensor, b16: torch.Tensor, splits: int | None = None,
                     tile_rows: int | None = None, stages: int | None = None):
    """Launch K4 on bf16 (Ka,128) and (Kb,128) CUDA tensors; ``tile_rows`` and
    ``stages`` default to the library's own (the tuning sweep passes others)."""
    lib = _lib()
    Ka, Kb = a16.shape[0], b16.shape[0]
    tile_rows = lib.mt_tile_rows() if tile_rows is None else tile_rows
    stages = lib.mt_stages() if stages is None else stages
    if Kb % tile_rows:
        raise ValueError(f"the CUDA kernel needs Kb % {tile_rows} == 0, got Kb={Kb}")
    n, _per = split_plan(Ka, Kb, splits, tile_rows=tile_rows)
    dev = a16.device
    s1 = torch.empty((Ka,), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    i1 = torch.empty((Ka,), dtype=torch.int32, device=dev)
    if Ka == 0:
        return s1, i1, s2
    ps1 = ps2 = pi1 = None
    if n > 1:                               # the splits' partial results
        ps1 = torch.empty((n, Ka), dtype=torch.float32, device=dev)
        ps2 = torch.empty_like(ps1)
        pi1 = torch.empty((n, Ka), dtype=torch.int32, device=dev)
    err = lib.mt_match_top2(a16.data_ptr(), b16.data_ptr(), Ka, Kb, s1.data_ptr(), i1.data_ptr(),
                            s2.data_ptr(), *(None if x is None else x.data_ptr()
                                             for x in (ps1, pi1, ps2)),
                            n, tile_rows, stages, _build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"match_top2: {lib.mt_error_string(err).decode()} ({err})")
    _build.LAUNCHES.add("match_top2", 1 if n == 1 else 2)
    return s1, i1, s2


def match_top2(desc_a: torch.Tensor, desc_b: torch.Tensor, *,
               tile_a: int = 256, tile_b: int = 2048, splits: int | None = None):
    """K4 streaming top-2: returns (s1 f32, i1 int32, s2 f32), each (Ka,).

    desc_a (Ka,D), desc_b (Kb,D) float; Ka % tile_a == 0 and Kb % tile_b == 0
    (pad with zero rows, as ``match_float_streaming`` does).  On the card
    D <= 128 and tile_b a multiple of the kernel's landmark tile (128 rows);
    ``splits`` forces the number of ranges the landmark loop is cut into
    (None: ``split_plan`` chooses); the result does not depend on it.
    """
    Ka, D = desc_a.shape
    Kb, Db = desc_b.shape
    if D != Db or Ka % tile_a or Kb % tile_b:
        raise ValueError(f"match_top2 needs equal widths and Ka % tile_a == Kb % tile_b "
                         f"== 0, got {tuple(desc_a.shape)}, {tuple(desc_b.shape)}, "
                         f"tiles {tile_a}, {tile_b}")
    if desc_a.device.type == "cpu" and desc_b.device.type == "cpu":
        return match_top2_plain(desc_a, desc_b)
    for name, x in (("desc_a", desc_a), ("desc_b", desc_b)):
        if x.device.type != "cuda" or x.device != desc_a.device:
            raise ValueError(f"{name} must be on {desc_a.device} (CUDA), got {x.device}")
        if not x.is_floating_point():
            raise ValueError(f"{name} must be floating point, got {x.dtype}")
    if D > D_MAX or Kb % TILE_ROWS:
        raise ValueError(f"the CUDA kernel needs D <= {D_MAX} and Kb % {TILE_ROWS} == 0, "
                         f"got D={D}, Kb={Kb}")
    a16 = F.pad(desc_a.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    b16 = F.pad(desc_b.to(torch.bfloat16), (0, D_MAX - D)).contiguous()
    return _match_top2_cuda(a16, b16, splits)


def match_top2_reference(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """Dense oracle (bf16-rounded inputs, f32 GEMM, whole (Ka,Kb) matrix,
    ``topk_lowest_index`` for the reference's ``lax.top_k`` tie rule)."""
    sim = (desc_a.to(torch.bfloat16).to(torch.float32)
           @ desc_b.to(torch.bfloat16).to(torch.float32).T)
    v, i = topk_lowest_index(sim, 2)
    return v[:, 0], i[:, 0].to(torch.int32), v[:, 1]


def match_float_streaming(desc_a: torch.Tensor, desc_b: torch.Tensor,
                          mask_a: torch.Tensor, mask_b: torch.Tensor, *,
                          ratio: float = 0.8, tile_a: int = 256,
                          tile_b: int = 2048) -> MatchResult:
    """Ratio-test matching of unit descriptors against a large pool on K4
    (no cross-check pass).

    Masked rows are zeroed, not dropped, and both sides are zero-padded to
    their tile multiples; pad rows score 0, so they can be the second best,
    or the best with an index >= Kb, which ``valid`` then rejects.
    """
    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    pa = round_up(max(Ka, tile_a), tile_a)
    pb = round_up(max(Kb, tile_b), tile_b)
    a = torch.where(mask_a[:, None], desc_a, torch.zeros_like(desc_a))
    b = torch.where(mask_b[:, None], desc_b, torch.zeros_like(desc_b))
    a = F.pad(a, (0, 0, 0, pa - Ka))
    b = F.pad(b, (0, 0, 0, pb - Kb))
    s1, i1, s2 = match_top2(a, b, tile_a=tile_a, tile_b=tile_b)
    s1, i1, s2 = s1[:Ka], i1[:Ka].to(torch.int64), s2[:Ka]
    d1 = torch.clamp(2.0 - 2.0 * s1, min=0.0)
    d2 = torch.clamp(2.0 - 2.0 * s2, min=1e-12)
    idx = torch.clamp(i1, 0, Kb - 1)
    ok = (d1 < ratio * ratio * d2) & mask_a & (i1 < Kb) & mask_b[idx]
    return MatchResult(idx=idx, valid=ok, score=s1)
