"""Columnar scene container and store (port of ``sfmx.mapstore.scene``).

A store is a directory of raw ``.npy`` files, one per column, plus a JSON
manifest; columns re-open with ``np.load(..., mmap_mode="r")``.  The format
is framework-neutral: the port reads what ``sfmx`` writes and ``sfmx`` reads
what the port writes.  ``Scene`` is the device-side struct of tensors with
static capacities and alive masks that the map build returns;
``load_scene_np`` gives the same columns as a mapping of numpy arrays, which
the serving side works from.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

FORMAT_VERSION = 2
# the reference Scene's columns, in its field order
SCENE_FIELDS = ("intr", "cam_k", "cam_R", "cam_t", "cam_alive", "X", "X_alive",
                "obs_cam", "obs_pt", "obs_uv", "obs_alive")


@dataclasses.dataclass
class Scene:
    """Fixed-capacity SfM scene. Shapes: C cams, P points, O observations, I intrinsics."""

    intr: torch.Tensor       # (I,7) fx fy cx cy k1 k2 k3
    cam_k: torch.Tensor      # (C,) int32 intrinsics index
    cam_R: torch.Tensor      # (C,3,3) world->cam
    cam_t: torch.Tensor      # (C,3)
    cam_alive: torch.Tensor  # (C,) bool registered cameras
    X: torch.Tensor          # (P,3) landmarks
    X_alive: torch.Tensor    # (P,) bool
    obs_cam: torch.Tensor    # (O,) int32
    obs_pt: torch.Tensor     # (O,) int32 landmark id
    obs_uv: torch.Tensor     # (O,2) pixel observations
    obs_alive: torch.Tensor  # (O,) bool

    @property
    def capacities(self):
        return (self.cam_R.shape[0], self.X.shape[0], self.obs_cam.shape[0])

    def counts(self):
        return (int(self.cam_alive.sum()), int(self.X_alive.sum()), int(self.obs_alive.sum()))

    @property
    def centers(self) -> torch.Tensor:
        """Camera centers -R^T t, (C,3)."""
        return -(self.cam_R.transpose(1, 2) @ self.cam_t[:, :, None])[:, :, 0]

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The scene's columns as numpy arrays (what ``load_scene_np`` gives)."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in SCENE_FIELDS}


def new_scene(n_cams: int, n_points: int, n_obs: int, intr, cam_k=None, *,
              device) -> Scene:
    """An empty scene of the given capacities on ``device``."""
    intr = torch.as_tensor(intr, dtype=torch.float32, device=device).reshape(-1, 7)
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return Scene(
        intr=intr,
        cam_k=(z(n_cams, torch.int32) if cam_k is None
               else torch.as_tensor(cam_k, dtype=torch.int32, device=device)),
        cam_R=torch.eye(3, dtype=torch.float32, device=device).repeat(n_cams, 1, 1),
        cam_t=z((n_cams, 3), torch.float32),
        cam_alive=z(n_cams, torch.bool),
        X=z((n_points, 3), torch.float32),
        X_alive=z(n_points, torch.bool),
        obs_cam=z(n_obs, torch.int32),
        obs_pt=z(n_obs, torch.int32),
        obs_uv=z((n_obs, 2), torch.float32),
        obs_alive=z(n_obs, torch.bool),
    )


def save_columns(path: str | Path, cols: dict[str, np.ndarray], manifest: dict):
    """Atomically write a columnar directory (temp dir + rename)."""
    path = Path(path)
    manifest = dict(manifest)
    manifest["columns"] = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in cols.items()}
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    for k, v in cols.items():
        np.save(tmp / f"{k}.npy", v)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if path.is_dir():
        shutil.rmtree(path)
    elif path.exists():
        path.unlink()  # legacy v1 single-file store being overwritten
        sidecar = path.with_suffix(path.suffix + ".manifest.json")
        if sidecar.exists():
            sidecar.unlink()
    os.replace(tmp, path)


def load_manifest(path: str | Path) -> dict | None:
    path = Path(path)
    man_path = (path / "manifest.json") if path.is_dir() \
        else path.with_suffix(path.suffix + ".manifest.json")
    if man_path.exists():
        return json.loads(man_path.read_text())
    return None


def load_columns(path: str | Path, *, mmap: bool = True) -> dict[str, np.ndarray]:
    """Load every column of a columnar directory's manifest (mmap'd by default)."""
    path = Path(path)
    man = load_manifest(path)
    if man is None:
        raise FileNotFoundError(f"no manifest at {path}")
    mode = "r" if mmap else None
    return {k: np.load(path / f"{k}.npy", mmap_mode=mode) for k in man["columns"]}


def load_scene_np(path: str | Path, *, mmap: bool = True) -> dict[str, np.ndarray]:
    """Host-side scene column load.  v2 directory stores mmap (nothing is
    materialized until touched); legacy v1 ``.npz`` files decompress."""
    path = Path(path)
    man = load_manifest(path)
    if man and man["format_version"] > FORMAT_VERSION:
        raise ValueError(f"scene format {man['format_version']} newer than supported")
    if path.is_dir():
        mode = "r" if mmap else None
        return {k: np.load(path / f"{k}.npy", mmap_mode=mode) for k in SCENE_FIELDS}
    with np.load(path) as z:  # v1: compressed npz, not mmap-able
        return {k: z[k] for k in z.files}


def save_scene(path: str | Path, scene: Scene, extra: dict | None = None):
    """Write the v2 columnar store ``path/`` (raw .npy columns + manifest),
    atomically; a legacy single-file store already at ``path`` is replaced."""
    cols = scene.to_numpy()
    manifest = {
        "format_version": FORMAT_VERSION,
        "capacities": {"cams": cols["cam_R"].shape[0], "points": cols["X"].shape[0],
                       "obs": cols["obs_cam"].shape[0], "intr": cols["intr"].shape[0]},
        "extra": extra or {},
    }
    save_columns(path, cols, manifest)


def load_scene(path: str | Path, device) -> Scene:
    cols = load_scene_np(path, mmap=False)
    return Scene(**{k: torch.as_tensor(np.asarray(cols[k]), device=device) for k in SCENE_FIELDS})
