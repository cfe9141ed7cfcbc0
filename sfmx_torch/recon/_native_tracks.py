"""ctypes bindings for the C++ track builder (``native/tracks.cpp``).

The source compiles at first use with ``g++`` into ``sfmx_torch/_build/``
(git-ignored), keyed on a hash of the source and the flags, so an edit
triggers a rebuild.  A failed build raises: the caller chose the native
builder, and nothing falls back quietly.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "tracks.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-std=c++17", "-shared", "-fPIC", "-O3", "-DNDEBUG")

_LIB: list[ctypes.CDLL] = []


def _lib() -> ctypes.CDLL:
    if _LIB:
        return _LIB[0]
    src = SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtracks-{key}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".tmp-{os.getpid()}")
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i32p, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
    lib.sfmx_build_tracks.restype = i64
    lib.sfmx_build_tracks.argtypes = [
        i32p, i64, i32p, ctypes.POINTER(ctypes.c_uint8), i64, i64, i64, i64,
        i32p, i32p, i32p, i64, ctypes.POINTER(ctypes.c_int64)]
    lib.sfmx_covisibility.restype = None
    lib.sfmx_covisibility.argtypes = [i32p, i32p, i64, i64, i32p]
    _LIB.append(lib)
    return lib


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def build_tracks(pair_list, match_idx, match_valid, n_images: int, max_feats: int,
                 min_length: int = 2):
    """Native ``tracks.build_tracks`` (same semantics, tested for parity)."""
    from .tracks import TrackTable

    lib = _lib()
    pair_list = np.ascontiguousarray(pair_list, np.int32)
    match_idx = np.ascontiguousarray(match_idx, np.int32)
    match_valid = np.ascontiguousarray(match_valid, np.uint8)
    n_pairs, K = match_idx.shape
    if pair_list.shape != (n_pairs, 2) or match_valid.shape != (n_pairs, K):
        raise ValueError(f"shapes disagree: pairs {pair_list.shape}, idx {match_idx.shape}, "
                         f"valid {match_valid.shape}")
    v = match_valid.astype(bool)
    if v.any() and (pair_list.min() < 0 or pair_list.max() >= n_images
                    or match_idx[v].min() < 0 or match_idx[v].max() >= max_feats
                    or K > max_feats):
        raise ValueError("pair or feature index out of range")
    cap = int(2 * v.sum()) + 16
    out_cam = np.empty(cap, np.int32)
    out_feat = np.empty(cap, np.int32)
    out_track = np.empty(cap, np.int32)
    n_tracks = ctypes.c_int64(0)
    n = lib.sfmx_build_tracks(
        _ptr(pair_list, ctypes.c_int32), n_pairs,
        _ptr(match_idx, ctypes.c_int32), _ptr(match_valid, ctypes.c_uint8), K,
        n_images, max_feats, min_length,
        _ptr(out_cam, ctypes.c_int32), _ptr(out_feat, ctypes.c_int32),
        _ptr(out_track, ctypes.c_int32), cap, ctypes.byref(n_tracks))
    if n < 0:
        raise RuntimeError("track output capacity exceeded")
    return TrackTable(out_cam[:n].copy(), out_feat[:n].copy(), out_track[:n].copy(),
                      int(n_tracks.value))


def covisibility_counts(tt, n_images: int) -> np.ndarray:
    """Native ``tracks.covisibility_counts``: (C,C) shared-track counts."""
    lib = _lib()
    out = np.zeros((n_images, n_images), np.int32)
    obs_cam = np.ascontiguousarray(tt.obs_cam, np.int32)
    obs_track = np.ascontiguousarray(tt.obs_track, np.int32)
    lib.sfmx_covisibility(_ptr(obs_cam, ctypes.c_int32), _ptr(obs_track, ctypes.c_int32),
                          len(obs_cam), n_images, _ptr(out, ctypes.c_int32))
    return out
