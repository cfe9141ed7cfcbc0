"""Textured-room renderer, frozen: a copy of the room half of
``examples/room.py`` at commit 9fe1547 (``RoomTexture``, ``look_at``,
``render_room``, ``walk_poses``; the arc poses and the corridor left out).

Ray-casts a box-room interior (6 value-noise textured faces) — the geometry
class the reference targets (indoor walkthroughs, locally planar surfaces).
Pure numpy; fast enough for a handful of QVGA frames.
"""
from __future__ import annotations

import numpy as np

ROOM = np.array([[-5.0, 5.0], [-2.5, 2.5], [-5.0, 5.0]])  # x, y, z extents


class RoomTexture:
    def __init__(self, seed=0, res=96, octaves=4):
        # res is the FINEST grid; on a 10m face seen from ~5m at f=280 a texel
        # is then ~15px on screen — structure detectors can latch onto.
        # Finer grids alias into view-inconsistent noise.
        rng = np.random.default_rng(seed)
        self.grids = [rng.standard_normal((6, res // (2**o) + 2, res // (2**o) + 2))
                      for o in range(octaves)]
        self.res = res
        self.octaves = octaves

    def sample(self, face, u, v):
        """face: (N,) int, u,v in [0,1] -> intensity (N,)."""
        out = np.zeros_like(u)
        for o, g in enumerate(self.grids):
            n = g.shape[1] - 2
            x = u * n
            y = v * n
            x0 = np.clip(x.astype(int), 0, n - 1)
            y0 = np.clip(y.astype(int), 0, n - 1)
            fx = x - x0
            fy = y - y0
            v00 = g[face, y0, x0]
            v01 = g[face, y0, x0 + 1]
            v10 = g[face, y0 + 1, x0]
            v11 = g[face, y0 + 1, x0 + 1]
            # smoothstep for C1 continuity (gives corners, not just ramps)
            fx = fx * fx * (3 - 2 * fx)
            fy = fy * fy * (3 - 2 * fy)
            val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                   + v10 * (1 - fx) * fy + v11 * fx * fy)
            out += val * (1.5 ** o)  # coarse octaves dominate (smooth base + detail)
        return out


def look_at(eye, target, up=np.array([0.0, 1.0, 0.0])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def render_room(tex: RoomTexture, R, eye, width=320, height=240, focal=280.0):
    """Render the room interior from world-to-cam rotation R, camera center eye."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    xn = (xs - width / 2) / focal
    yn = (ys - height / 2) / focal
    dirs_cam = np.stack([xn, yn, np.ones_like(xn)], -1).reshape(-1, 3)
    dirs = dirs_cam @ R  # R^T @ d
    N = dirs.shape[0]
    best_t = np.full(N, np.inf)
    best_face = np.zeros(N, int)
    best_uv = np.zeros((N, 2))
    face = 0
    for axis in range(3):
        for side in range(2):
            bound = ROOM[axis, side]
            d = dirs[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (bound - eye[axis]) / d
            t = np.where(np.abs(d) < 1e-12, np.inf, t)
            # inf * 0 rays (parallel to the face) are masked below; keep
            # the arithmetic finite so numpy stays quiet
            with np.errstate(invalid="ignore"):
                pt = eye[None, :] + t[:, None] * dirs
            oa = [a for a in range(3) if a != axis]
            inside = (
                (t > 1e-6)
                & (pt[:, oa[0]] >= ROOM[oa[0], 0] - 1e-6) & (pt[:, oa[0]] <= ROOM[oa[0], 1] + 1e-6)
                & (pt[:, oa[1]] >= ROOM[oa[1], 0] - 1e-6) & (pt[:, oa[1]] <= ROOM[oa[1], 1] + 1e-6)
            )
            better = inside & (t < best_t)
            best_t = np.where(better, t, best_t)
            best_face = np.where(better, face, best_face)
            u = (pt[:, oa[0]] - ROOM[oa[0], 0]) / (ROOM[oa[0], 1] - ROOM[oa[0], 0])
            v = (pt[:, oa[1]] - ROOM[oa[1], 0]) / (ROOM[oa[1], 1] - ROOM[oa[1], 0])
            best_uv[better] = np.stack([u, v], -1)[better]
            face += 1
    img = tex.sample(best_face, np.clip(best_uv[:, 0], 0, 1), np.clip(best_uv[:, 1], 0, 1))
    img = img.reshape(height, width)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
    return img.astype(np.float32)


def walk_poses(n, heading_deg=25.0):
    """Walkthrough poses: translate across the room with gentle heading drift.

    Translation-dominant motion (the geometry SfM needs): ~0.5m steps with
    walls 3-8m away gives several degrees of parallax per frame.
    """
    poses = []
    s = np.linspace(0.0, 1.0, n)
    for i, si in enumerate(s):
        eye = np.array([-3.0 + 6.0 * si, 0.2 * np.sin(6 * si), -3.0 + 2.0 * si])
        yaw = np.deg2rad(heading_deg + 20.0 * si)
        d = np.array([np.sin(yaw), 0.12 * np.sin(4 * si), np.cos(yaw)])
        R, t = look_at(eye, eye + 5.0 * d)
        poses.append((R, t, eye))
    return poses


def render_room_torch(tex: RoomTexture, Rs, eyes, width: int, height: int, focal: float,
                      device, chunk: int = 16):
    """``render_room`` of N poses at once on ``device`` in float64 torch:
    Rs (N,3,3) world-to-camera rotations, eyes (N,3) camera centers ->
    (N,H,W) float32 numpy frames.  The same arithmetic as ``render_room``."""
    import torch

    f64 = torch.float64
    ROOM_t = torch.as_tensor(ROOM, dtype=f64, device=device)
    grids = [torch.as_tensor(g, dtype=f64, device=device) for g in tex.grids]
    ys, xs = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device), indexing="ij")
    d_cam = torch.stack([(xs - width / 2) / focal, (ys - height / 2) / focal,
                         torch.ones_like(xs)], -1).reshape(-1, 3)
    out = []
    for s in range(0, len(Rs), chunk):
        R = torch.as_tensor(np.asarray(Rs[s:s + chunk]), dtype=f64, device=device)
        eye = torch.as_tensor(np.asarray(eyes[s:s + chunk]), dtype=f64, device=device)
        dirs = d_cam[None] @ R                                     # (n,HW,3)
        n, N = dirs.shape[:2]
        best_t = torch.full((n, N), torch.inf, dtype=f64, device=device)
        best_face = torch.zeros((n, N), dtype=torch.int64, device=device)
        best_uv = torch.zeros((n, N, 2), dtype=f64, device=device)
        face = 0
        for axis in range(3):
            oa = [a for a in range(3) if a != axis]
            for side in range(2):
                d = dirs[..., axis]
                t = (ROOM_t[axis, side] - eye[:, axis:axis + 1]) / d
                t = torch.where(torch.abs(d) < 1e-12, torch.full_like(t, torch.inf), t)
                pt = eye[:, None, :] + t[..., None] * dirs
                p0, p1 = pt[..., oa[0]], pt[..., oa[1]]
                inside = ((t > 1e-6) & (p0 >= ROOM_t[oa[0], 0] - 1e-6) & (p0 <= ROOM_t[oa[0], 1] + 1e-6)
                          & (p1 >= ROOM_t[oa[1], 0] - 1e-6) & (p1 <= ROOM_t[oa[1], 1] + 1e-6))
                better = inside & (t < best_t)
                best_t = torch.where(better, t, best_t)
                best_face = torch.where(better, torch.full_like(best_face, face), best_face)
                u = (p0 - ROOM_t[oa[0], 0]) / (ROOM_t[oa[0], 1] - ROOM_t[oa[0], 0])
                v = (p1 - ROOM_t[oa[1], 0]) / (ROOM_t[oa[1], 1] - ROOM_t[oa[1], 0])
                best_uv = torch.where(better[..., None], torch.stack([u, v], -1), best_uv)
                face += 1
        u = torch.clamp(best_uv[..., 0], 0, 1)
        v = torch.clamp(best_uv[..., 1], 0, 1)
        img = torch.zeros_like(u)
        for o, g in enumerate(grids):
            m = g.shape[1] - 2
            x, y = u * m, v * m
            x0 = torch.clamp(x.to(torch.int64), 0, m - 1)
            y0 = torch.clamp(y.to(torch.int64), 0, m - 1)
            fx, fy = x - x0, y - y0
            fx = fx * fx * (3 - 2 * fx)
            fy = fy * fy * (3 - 2 * fy)
            flat = g.reshape(-1)
            base = best_face * (m + 2) * (m + 2)

            def at(yy, xx):
                return flat[base + yy * (m + 2) + xx]

            val = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
                   + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
            img = img + val * (1.5 ** o)
        lo = img.amin(dim=1, keepdim=True)
        hi = img.amax(dim=1, keepdim=True)
        img = (img - lo) / torch.clamp(hi - lo, min=1e-9)
        out.append(img.reshape(n, height, width).to(torch.float32).cpu().numpy())
    return np.concatenate(out)
