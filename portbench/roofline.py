"""Peaks of the card and the work each kernel's roofline share counts.

The work is counted from the traffic the benchmark sent (requests, images,
keypoint rows, landmarks), never from launches or the program's shapes, so
the count stays the same whatever implements a kernel.  A share is the
least time the card could take over the kernel's traced device time: the
larger of the operations at the peak rate of their type and the bytes at
the memory rate.  Peaks are NVIDIA's published rates for one H100 SXM
(dense, 700 W).
"""
from __future__ import annotations

PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

FED_FLOP_PER_PX = 30.0   # 4 differences, 4 conductivities with a division each, flux, update


def fed_steps(sigma_levels=(2, 3, 4, 5, 6), tau_max: float = 0.25) -> list[int]:
    """FED steps of each level segment (level i-1 -> i)."""
    out = []
    for a, b in zip(sigma_levels[:-1], sigma_levels[1:]):
        T = 0.5 * (b * b - a * a)
        n = 1
        while tau_max * n * (n + 1) / 3.0 < T:
            n += 1
        out.append(n)
    return out


def match_top2_work(rows: int, landmarks: int, dim: int = 128) -> dict:
    """K4: every query row against every landmark, bf16 inputs: a
    multiply-add a dimension; both sides read once, (s1, i1, s2) written."""
    return {"ops": 2.0 * rows * landmarks * dim, "kind": "bf16",
            "bytes": (rows + landmarks) * dim * 2.0 + rows * 12.0}


def diffuse_segment_work(images: int, height: int, width: int, octaves: int = 2,
                         sigma_levels=(2, 3, 4, 5, 6)) -> dict:
    """K1: every FED step on every pixel of every octave; each segment reads
    and writes its level once (f32)."""
    steps = fed_steps(sigma_levels)
    ops = nbytes = 0.0
    h, w = height, width
    for _o in range(octaves):
        px = float(images) * h * w
        ops += FED_FLOP_PER_PX * px * sum(steps)
        nbytes += len(steps) * 2 * px * 4
        h, w = h // 2, w // 2
    return {"ops": ops, "kind": "f32", "bytes": nbytes}


def bound_s(work: dict) -> tuple[float, str]:
    t_o = work["ops"] / PEAK_OPS_S[work["kind"]]
    t_b = work["bytes"] / HBM_BYTES_S
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def share(work: dict, device_s: float) -> float | None:
    """Roofline share in %, or None where the kernel left no device time."""
    if device_s <= 0 or work["ops"] <= 0:
        return None
    return 100.0 * bound_s(work)[0] / device_s
