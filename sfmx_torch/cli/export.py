"""Map export for visualization: PLY point cloud + trajectory + frusta
(port of ``sfmx.cli.export``).

Host-side numpy: landmarks are colored by track length (observation count)
on a viridis-like ramp, camera centers red, and each camera gets a
5-vertex frustum wireframe (PLY edge elements) sized from its intrinsics.
Binary little-endian PLY opens in MeshLab, CloudCompare and Open3D.
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """A scene column as numpy (tensors from any device, or arrays)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _viridis(x: np.ndarray) -> np.ndarray:
    """Tiny 5-stop viridis approximation, x in [0,1] -> (N,3) uint8."""
    stops = np.asarray([
        [68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
        [253, 231, 37]], np.float32)
    x = np.clip(x, 0.0, 1.0) * (len(stops) - 1)
    i = np.minimum(x.astype(np.int32), len(stops) - 2)
    f = (x - i)[:, None]
    return (stops[i] * (1 - f) + stops[i + 1] * f).astype(np.uint8)


def scene_to_ply_arrays(scene, frustum_scale: float = 0.15):
    """Build (vertices (N,3) f32, colors (N,3) u8, edges (E,2) i32) from a
    ``Scene`` (tensors on any device)."""
    X = _np(scene.X)
    X_alive = _np(scene.X_alive)
    obs_pt = _np(scene.obs_pt)[_np(scene.obs_alive)]
    track_len = np.bincount(obs_pt, minlength=X.shape[0]).astype(np.float32)

    pts = X[X_alive]
    tl = track_len[X_alive]
    hi = max(np.percentile(tl, 95), 3.0) if len(tl) else 3.0
    pt_col = _viridis(tl / hi)

    centers = _np(scene.centers)
    Rs = _np(scene.cam_R)
    cam_alive = _np(scene.cam_alive)
    intr = _np(scene.intr)
    cam_k = _np(scene.cam_k)

    verts = [pts.astype(np.float32)]
    cols = [pt_col]
    edges = []
    n = len(pts)
    prev_center_idx = None
    for c in np.flatnonzero(cam_alive):
        k = intr[cam_k[c]]
        # frustum corners at unit depth in the camera frame -> world
        w = k[2] / k[0] * frustum_scale  # half-width/height of the image plane
        h = k[3] / k[1] * frustum_scale
        corners_c = np.asarray([
            [0, 0, 0], [-w, -h, frustum_scale], [w, -h, frustum_scale],
            [w, h, frustum_scale], [-w, h, frustum_scale]], np.float32)
        corners_w = corners_c @ Rs[c] + centers[c]  # R^T x + C
        base = n
        verts.append(corners_w.astype(np.float32))
        cols.append(np.tile(np.asarray([[220, 40, 40]], np.uint8), (5, 1)))
        # apex->corners + image-plane rectangle
        edges += [[base, base + i] for i in range(1, 5)]
        edges += [[base + 1, base + 2], [base + 2, base + 3],
                  [base + 3, base + 4], [base + 4, base + 1]]
        if prev_center_idx is not None:  # trajectory polyline between apexes
            edges.append([prev_center_idx, base])
        prev_center_idx = base
        n += 5

    verts = np.concatenate(verts) if verts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(cols) if cols else np.zeros((0, 3), np.uint8)
    edges = np.asarray(edges, np.int32) if edges else np.zeros((0, 2), np.int32)
    return verts, cols, edges


def write_ply(path, verts: np.ndarray, cols: np.ndarray,
              edges: np.ndarray | None = None) -> None:
    """Binary little-endian PLY with per-vertex color and optional edges."""
    n, e = len(verts), 0 if edges is None else len(edges)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
    ]
    if e:
        header += [f"element edge {e}",
                   "property int vertex1", "property int vertex2"]
    header.append("end_header")
    vrec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vrec["xyz"] = verts.astype("<f4")
    vrec["rgb"] = cols
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vrec.tobytes())
        if e:
            f.write(edges.astype("<i4").tobytes())


def export_scene_ply(scene, path, frustum_scale: float = 0.15) -> dict:
    """Export a Scene to PLY; returns summary counts."""
    verts, cols, edges = scene_to_ply_arrays(scene, frustum_scale)
    write_ply(path, verts, cols, edges)
    return {"vertices": int(len(verts)), "edges": int(len(edges)), "path": str(path)}
