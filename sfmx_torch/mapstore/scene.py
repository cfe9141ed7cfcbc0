"""Columnar store helpers (port of ``sfmx.mapstore.scene``'s numpy part).

A store is a directory of raw ``.npy`` files, one per column, plus a JSON
manifest; columns re-open with ``np.load(..., mmap_mode="r")``.  The format
is framework-neutral, so the port reads what ``sfmx`` writes.  A scene
(``load_scene_np``) is kept as a mapping of numpy columns; the device-side
``Scene`` belongs to the map-build path.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

FORMAT_VERSION = 2
# the reference Scene's columns, in its field order
SCENE_FIELDS = ("intr", "cam_k", "cam_R", "cam_t", "cam_alive", "X", "X_alive",
                "obs_cam", "obs_pt", "obs_uv", "obs_alive")


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
