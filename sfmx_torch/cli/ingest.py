"""Image ingest and workspace listing (port of ``sfmx.cli.ingest``).

Enumerate images (or pull frames from a walkthrough video), initialize the
intrinsics (EXIF focal or a default) and produce the workspace that the map
build and localization consume.  Decoding is host I/O through PIL or cv2,
imported inside the functions that need them; the output is a (B,H,W)
float32 batch in [0,1] plus an intrinsics table, bit-equal to the
reference's for the same files (the same PIL and cv2 calls).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".pgm", ".tif", ".tiff"}


@dataclasses.dataclass
class Workspace:
    image_paths: list[str]
    images: np.ndarray      # (B,H,W) float32 grayscale in [0,1]
    intrinsics: np.ndarray  # (I,7)
    cam_k: np.ndarray       # (B,) intrinsics index per image
    orig_sizes: np.ndarray  # (B,2) original (w,h)


def default_intrinsics(width: int, height: int, focal_factor: float = 1.2) -> np.ndarray:
    """Standard SfM initialization: f = factor * max(w,h), principal at center."""
    f = focal_factor * max(width, height)
    return np.array([f, f, width / 2.0, height / 2.0, 0.0, 0.0, 0.0], np.float32)


def _load_gray(path: Path, size: tuple[int, int] | None):
    """Decode one image to (H,W) float32 gray in [0,1] and its original (w,h)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    orig = img.size  # (w,h)
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr, orig


def exif_focal_px(path: Path, width: int) -> float | None:
    """Focal length in pixels from EXIF (FocalLengthIn35mmFilm), if present."""
    try:
        from PIL import Image
        from PIL.ExifTags import TAGS

        exif = Image.open(path).getexif()
        for tag_id, val in exif.items():
            if TAGS.get(tag_id) == "FocalLengthIn35mmFilm" and val:
                return float(val) / 36.0 * width
    except Exception:
        return None
    return None


def load_directory(path: str | Path, *, resize_to: tuple[int, int] | None = (640, 480),
                   focal_factor: float = 1.2, intrinsics: np.ndarray | None = None) -> Workspace:
    """Enumerate and decode all images in a directory (sorted by name)."""
    files = list_images(path)
    images, sizes = [], []
    for p in files:
        arr, orig = _load_gray(p, resize_to)
        images.append(arr)
        sizes.append(orig)
    images = np.stack(images)
    B, H, W = images.shape
    if intrinsics is None:
        f = exif_focal_px(files[0], W) or None
        intr = default_intrinsics(W, H, focal_factor)
        if f is not None:
            intr[0] = intr[1] = f
        intrinsics = intr[None]
    return Workspace(
        image_paths=[str(p) for p in files],
        images=images,
        intrinsics=np.asarray(intrinsics, np.float32).reshape(-1, 7),
        cam_k=np.zeros(B, np.int32),
        orig_sizes=np.asarray(sizes, np.int32),
    )


def iter_decoded_chunks(paths, *, resize_to: tuple[int, int] | None = (640, 480),
                        chunk: int = 16, workers: int = 8, prefetch: int = 2):
    """Threaded image decoding with a bounded lookahead.

    Yields ``(images (b,H,W) float32, orig_sizes (b,2) int32)`` in path order
    while a thread pool decodes up to ``chunk * (prefetch + 1)`` images ahead.
    PIL's decode releases the GIL, so decoding overlaps the caller's Python
    and the card's work queued by it.  Host memory stays O(chunk * prefetch)
    whatever the number of images.
    """
    import itertools
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    paths = [Path(p) for p in paths]
    if not paths:
        return
    ex = ThreadPoolExecutor(max_workers=workers)
    try:
        n_ahead = max(chunk * (prefetch + 1), 1)
        it = iter(paths)
        # _load_gray is looked up at call time, so a caller may rebind it
        pending: deque = deque(
            ex.submit(_load_gray, p, resize_to) for p in itertools.islice(it, n_ahead))
        buf: list = []
        while pending:
            fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(_load_gray, nxt, resize_to))
            buf.append(fut.result())
            if len(buf) == chunk:
                yield (np.stack([a for a, _ in buf]),
                       np.asarray([s for _, s in buf], np.int32))
                buf = []
        if buf:
            yield (np.stack([a for a, _ in buf]),
                   np.asarray([s for _, s in buf], np.int32))
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def list_images(path: str | Path) -> list[Path]:
    """Sorted image files in a directory (the workspace listing)."""
    path = Path(path)
    files = sorted(p for p in path.iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if not files:
        raise FileNotFoundError(f"no images in {path}")
    return files


def load_video(path: str | Path, *, every_n: int = 10,
               resize_to: tuple[int, int] | None = (640, 480),
               focal_factor: float = 1.2, max_frames: int = 2000) -> Workspace:
    """Extract every n-th frame from a walkthrough video (cv2 decodes)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    i = 0
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every_n == 0:
            g = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if resize_to is not None:
                g = cv2.resize(g, resize_to)
            frames.append(g.astype(np.float32) / 255.0)
        i += 1
    cap.release()
    if not frames:
        raise FileNotFoundError(f"no frames decoded from {path}")
    images = np.stack(frames)
    B, H, W = images.shape
    return Workspace(
        image_paths=[f"{path}#frame{j * every_n}" for j in range(B)],
        images=images,
        intrinsics=default_intrinsics(W, H, focal_factor)[None],
        cam_k=np.zeros(B, np.int32),
        orig_sizes=np.asarray([[W, H]] * B, np.int32),
    )
