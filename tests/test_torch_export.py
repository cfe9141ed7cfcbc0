"""PLY export on the port (``sfmx_torch.cli.export``), mirroring
tests/test_export.py on a scene the port reconstructs from the same
synthetic features, plus parity: ``scene_to_ply_arrays`` of the same scene
arrays equals ``sfmx``'s exactly (the same numpy on the host)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.cli import export as jexport
from sfmx.mapstore.scene import Scene as JScene
from sfmx_torch.cli.export import export_scene_ply, scene_to_ply_arrays, write_ply
from sfmx_torch.kernels import matching
from sfmx_torch.recon import tracks
from sfmx_torch.recon.incremental import ReconConfig, reconstruct
from tests.synthetic import make_scene
from tests.test_matching_tracks import scene_features

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    sc = make_scene(n_cams=8, n_points=250, noise_px=0.3, seed=3)
    uv, desc, mask, _ = scene_features(sc, rng, noise=0.05)
    C = uv.shape[0]
    pairs = np.array([(a, b) for a in range(C) for b in range(a + 1, C)], np.int32)
    res = matching.match_pairs_float(torch.from_numpy(desc), torch.from_numpy(mask), pairs)
    tt = tracks.build_tracks(pairs, res.idx.numpy(), res.valid.numpy(), C, uv.shape[1])
    scene, stats = reconstruct(uv, mask, tt, sc.intrinsics[None].astype(np.float32),
                               np.zeros(C, np.int32), ReconConfig(ba_every=3), device="cpu")
    assert stats["n_registered"] == C
    return scene


def _parse_ply(path):
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    assert lines[0] == "ply" and "binary_little_endian" in lines[1]
    nv = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    ne_lines = [l for l in lines if l.startswith("element edge")]
    ne = int(ne_lines[0].split()[-1]) if ne_lines else 0
    vrec = np.frombuffer(body[:nv * 15], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    edges = np.frombuffer(body[nv * 15:nv * 15 + ne * 8], "<i4").reshape(ne, 2)
    return vrec, edges


def test_export_scene_ply(tmp_path, scene):
    out = tmp_path / "map.ply"
    summary = export_scene_ply(scene, out)
    vrec, edges = _parse_ply(out)
    n_pts = int(scene.X_alive.sum())
    n_cams = int(scene.cam_alive.sum())
    assert summary["vertices"] == len(vrec) == n_pts + 5 * n_cams
    # frusta: 8 edges per camera + trajectory polyline between cameras
    assert summary["edges"] == len(edges) == 8 * n_cams + (n_cams - 1)
    assert edges.min() >= 0 and edges.max() < len(vrec)
    # landmark vertices coincide with alive scene points
    X = scene.X[scene.X_alive].numpy()
    np.testing.assert_allclose(vrec["xyz"][:n_pts], X.astype(np.float32), rtol=1e-6)
    assert len(np.unique(vrec["rgb"][:n_pts], axis=0)) > 1


def test_write_ply_no_edges(tmp_path):
    v = np.zeros((3, 3), np.float32)
    c = np.full((3, 3), 7, np.uint8)
    p = tmp_path / "pts.ply"
    write_ply(p, v, c, None)
    vrec, edges = _parse_ply(p)
    assert len(vrec) == 3 and len(edges) == 0


@pytest.mark.parametrize("frustum_scale", [0.15, 0.4])
def test_ply_arrays_match_reference(scene, frustum_scale):
    cols = scene.to_numpy()
    jscene = JScene(**{k: jnp.asarray(v) for k, v in cols.items()})
    got = scene_to_ply_arrays(scene, frustum_scale)
    want = jexport.scene_to_ply_arrays(jscene, frustum_scale)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # the frusta's corners: R^T x + C from the centers, which each package
    # computes from (R, t) on its own side (f32 matmul; 1e-6 of the extent)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-6 * float(np.abs(want[0]).max()))
