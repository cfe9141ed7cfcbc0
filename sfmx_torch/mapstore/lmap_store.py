"""Persisted serving map: the LocalizationMap columnar store
(port of ``sfmx.mapstore.lmap_store``).

Reads and writes the same ``.npy``-column store that ``sfmx build-map``
writes, so the port serves a map that ``sfmx`` built and vice versa.  Packed
descriptor bits are uint32 on disk and int32 (bit-identical) in torch.
"""
from __future__ import annotations

from pathlib import Path


from ..localize.localize import LocalizationMap
from .scene import load_columns, load_manifest, save_columns

LMAP_FORMAT_VERSION = 1


def save_localization_map(path: str | Path, lmap: LocalizationMap,
                          extra: dict | None = None):
    """Atomically persist a LocalizationMap as a columnar directory."""
    cols = lmap.to_numpy()
    manifest = {
        "store": "localization_map",
        "format_version": LMAP_FORMAT_VERSION,
        "counts": {"landmarks": cols["X"].shape[0],
                   "keyframes": cols["kf_gdesc"].shape[0]},
        "extra": extra or {},
    }
    save_columns(path, cols, manifest)


def load_localization_map(path: str | Path, device, *, mmap: bool = True
                          ) -> LocalizationMap:
    """Load a persisted LocalizationMap onto ``device``.  No aggregation or
    vocabulary training happens here."""
    man = load_manifest(path)
    if man is None or man.get("store") != "localization_map":
        raise FileNotFoundError(f"no localization-map store at {path}")
    if man["format_version"] > LMAP_FORMAT_VERSION:
        raise ValueError(f"lmap format {man['format_version']} newer than supported")
    cols = load_columns(path, mmap=mmap)
    return LocalizationMap.from_numpy(cols, device)


def has_localization_map(path: str | Path) -> bool:
    man = load_manifest(path)
    return man is not None and man.get("store") == "localization_map"
