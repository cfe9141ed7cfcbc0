"""Ingest on the port (``sfmx_torch.cli.ingest``) and streaming extraction,
mirroring tests/test_ingest.py (all but its renderer case), plus decode
parity with ``sfmx.cli.ingest``: the same files give bit-equal images,
sizes and intrinsics (both packages run the same PIL and cv2 calls).
Streaming extraction equals eager extraction of the same chunks bit for
bit, and one eager batch within K1's 1e-4 (the CPU's convolution rounds by
batch size: the streaming case says how)."""
import numpy as np
import pytest
import torch
from PIL import Image

from sfmx.cli import ingest as jingest
from sfmx_torch.cli.ingest import (default_intrinsics, iter_decoded_chunks, list_images,
                                   load_directory, load_video)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(4):
        arr = (rng.random((48, 64)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img{i:02d}.png")
    (d / "notes.txt").write_text("ignored")
    return d


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    import cv2

    p = str(tmp_path_factory.mktemp("video") / "walk.avi")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.default_rng(1)
    for _ in range(25):
        w.write((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    w.release()
    return p


def test_load_directory(image_dir):
    ws = load_directory(image_dir, resize_to=(32, 24))
    assert ws.images.shape == (4, 24, 32)
    assert ws.images.dtype == np.float32
    assert 0.0 <= ws.images.min() and ws.images.max() <= 1.0
    assert ws.intrinsics.shape == (1, 7)
    # default focal = 1.2 * max(w,h)
    assert ws.intrinsics[0, 0] == pytest.approx(1.2 * 32)
    assert len(ws.image_paths) == 4
    assert ws.image_paths == sorted(ws.image_paths)


def test_load_directory_empty(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_directory(tmp_path)


def test_default_intrinsics():
    k = default_intrinsics(640, 480)
    assert k[0] == k[1] == pytest.approx(768.0)
    assert (k[2], k[3]) == (320.0, 240.0)
    np.testing.assert_array_equal(k, jingest.default_intrinsics(640, 480))


@pytest.mark.parametrize("resize_to", [(32, 24), None])
def test_load_directory_matches_reference(image_dir, resize_to):
    """The same files decode bit-equal in both packages."""
    ws = load_directory(image_dir, resize_to=resize_to, focal_factor=0.9)
    ref = jingest.load_directory(image_dir, resize_to=resize_to, focal_factor=0.9)
    assert ws.image_paths == ref.image_paths
    for f in ("images", "intrinsics", "cam_k", "orig_sizes"):
        a, b = getattr(ws, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_iter_decoded_chunks_parity(image_dir):
    """Streaming decode yields the same pixels/order as the eager loader."""
    ws = load_directory(image_dir, resize_to=(32, 24))
    chunks = list(iter_decoded_chunks(list_images(image_dir), resize_to=(32, 24),
                                      chunk=3, workers=2, prefetch=1))
    assert [c[0].shape[0] for c in chunks] == [3, 1]  # tail chunk is partial
    streamed = np.concatenate([c[0] for c in chunks])
    np.testing.assert_array_equal(streamed, ws.images)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), ws.orig_sizes)


def test_extract_features_streaming_parity(image_dir):
    """Pipelined decode and extraction against the eager extraction.

    Bit for bit against eager extraction of the same chunks: the decode
    order and the one ``torch.cat`` add nothing.  Against one eager batch of
    all four images within a tolerance: on the CPU oneDNN picks its
    convolution's blocking by batch size, so the Gaussian blur of an image
    in a batch of 3 differs from the same image's in a batch of 4 by 1 ulp
    (1.2e-7), which the diffusion carries to ~7e-6 in a descriptor and the
    subpixel fit (a ratio of response differences, near-flat on these 32x24
    noise images) to 6e-4 px; so the valid keypoints are held equal in their
    mask and level, their uv within 1e-3 px and their descriptors within
    1e-4 (K1's stated tolerance)."""
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features, extract_features_streaming

    cfg = PipelineConfig()
    ws = load_directory(image_dir, resize_to=(32, 24))
    feats, sizes = extract_features_streaming(list_images(image_dir), cfg, "cpu", chunk=3,
                                              resize_to=(32, 24))
    assert feats.desc.shape[0] == 4 and len(sizes) == 4
    np.testing.assert_array_equal(sizes, ws.orig_sizes)
    parts = [extract_features(ws.images[s], cfg, "cpu") for s in (slice(0, 3), slice(3, 4))]
    fields = lambda f: f.kp + (f.desc, f.desc_bits)
    for a, *bs in zip(fields(feats), *map(fields, parts)):
        assert a.dtype == bs[0].dtype and torch.equal(a, torch.cat(bs))
    eager = extract_features(ws.images, cfg, "cpu")
    m = eager.kp.mask
    assert torch.equal(feats.kp.mask, m) and torch.equal(feats.kp.level[m], eager.kp.level[m])
    np.testing.assert_allclose(feats.kp.uv[m].numpy(), eager.kp.uv[m].numpy(), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(feats.desc[m].numpy(), eager.desc[m].numpy(), rtol=0, atol=1e-4)


def test_extract_features_streaming_empty():
    from sfmx_torch.cli.config import PipelineConfig
    from sfmx_torch.cli.pipeline import extract_features_streaming

    with pytest.raises(ValueError):
        extract_features_streaming([], PipelineConfig(), "cpu")


def test_load_video(video):
    ws = load_video(video, every_n=5, resize_to=(32, 24))
    assert ws.images.shape == (5, 24, 32)
    assert all("#frame" in s for s in ws.image_paths)
    ref = jingest.load_video(video, every_n=5, resize_to=(32, 24))
    assert ws.image_paths == ref.image_paths
    np.testing.assert_array_equal(ws.images, ref.images)
    np.testing.assert_array_equal(ws.intrinsics, ref.intrinsics)
