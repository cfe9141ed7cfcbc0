"""The port's command line (``python -m sfmx_torch.cli.main``) on the CPU,
mirroring tests/test_cli.py with ``--device cpu``: build-map, evaluate,
localize (batch and sequential), the stage cache, georeference, merge,
export and bundle/unbundle, each through ``main([...])``.

``bundle`` ships the map artifacts only (the reference's compile cache is
not ported), so the bundle case is mirrored without ``--cache`` and holds
the map artifacts alone.  Added: ``evaluate`` and ``georeference`` on one
store against ``sfmx``'s command bodies on the same arrays (the store
format is shared): counts exact, every number within 1e-5 (both align with
an f32 Umeyama: SVDs of a 3x3 covariance, rounded differently), the
georeferenced columns within 1e-5 of the map's extent.
"""
import argparse
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sfmx_torch.cli.main import main

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.room import RoomTexture, look_at, render_room, walk_poses  # noqa: E402

torch.set_num_threads(2)
MAP_ARGS = ["-D", "features.max_keypoints=384", "-D", "match.ratio=0.85",
            "-D", "resize_to=320,240", "-D", "focal_factor=0.875", "--device", "cpu"]


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    tex = RoomTexture(seed=3)
    poses = walk_poses(10)
    d_map = tmp_path_factory.mktemp("map_imgs")
    d_q = tmp_path_factory.mktemp("query_imgs")
    for i, (R, t, eye) in enumerate(poses[:8]):
        img = render_room(tex, R, eye, 320, 240, 280.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(d_map / f"f{i:03d}.png")
    # queries: interior poses with small offsets
    for i, si in enumerate((0.35, 0.6)):
        eye = np.array([-3.0 + 6.0 * si + 0.1, 0.2 * np.sin(6 * si) + 0.05,
                        -3.0 + 2.0 * si])
        yaw = np.deg2rad(25.0 + 20.0 * si + 3.0)
        d = np.array([np.sin(yaw), 0.12 * np.sin(4 * si), np.cos(yaw)])
        R, t = look_at(eye, eye + 5.0 * d)
        img = render_room(tex, R, eye, 320, 240, 280.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(d_q / f"q{i:03d}.png")
    return d_map, d_q, poses


@pytest.fixture(scope="module")
def built(image_dirs, tmp_path_factory):
    """One build-map store (with its stage cache) shared by the cases."""
    d_map = image_dirs[0]
    tmp = tmp_path_factory.mktemp("built")
    out = tmp / "map.npz"
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["build-map", str(d_map), "-o", str(out), "--workdir", str(tmp / "work"),
              *MAP_ARGS])
    return out, _last_json(buf.getvalue()), tmp


def test_cli_build_localize_evaluate(image_dirs, built, capsys):
    _, d_q, _ = image_dirs
    out, rec, tmp = built
    assert rec["registered"] >= 7
    assert rec["points"] > 100
    assert out.exists() and (tmp / "map.npz.feats.npz").exists()
    # the serving map is persisted at build time
    from sfmx_torch.mapstore.lmap_store import has_localization_map
    assert has_localization_map(tmp / "map.npz.lmap")

    main(["evaluate", str(out), "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert report["scene"]["reproj_rmse_px"] < 1.0

    main(["localize", str(out), str(d_q), *MAP_ARGS])
    results = json.loads(capsys.readouterr().out)
    assert len(results) == 2
    assert all(r["n_inliers"] >= 12 for r in results)
    assert all(r["confidence"] > 0.2 for r in results)
    assert [os.path.basename(r["image"]) for r in results] == ["q000.png", "q001.png"]


def test_cli_localize_sequential(image_dirs, built, capsys):
    d_map, _, _ = image_dirs
    out, _, _ = built
    main(["localize", str(out), str(d_map), "--sequential", *MAP_ARGS])
    rec = json.loads(capsys.readouterr().out)
    assert len(rec["frames"]) == 8
    assert sum(f["n_inliers"] >= 12 for f in rec["frames"]) >= 7
    assert any(f["tracked"] for f in rec["frames"])


def test_cli_stage_cache_hits(image_dirs, built, capsys):
    d_map, _, _ = image_dirs
    _, rec, tmp = built
    work = tmp / "work"
    n_cached = len(list((work / "stages").glob("*.pkl")))
    assert n_cached >= 2  # extract + match stages persisted
    # a second run reuses the stage outputs (same key -> no recompute)
    main(["build-map", str(d_map), "-o", str(tmp / "m2.npz"), "--workdir", str(work),
          *MAP_ARGS])
    rec2 = _last_json(capsys.readouterr().out)
    assert (tmp / "m2.npz").exists()
    assert len(list((work / "stages").glob("*.pkl"))) == n_cached
    assert rec2["registered"] == rec["registered"]


def test_cli_build_map_stream(image_dirs, tmp_path, capsys):
    d_map, _, _ = image_dirs
    out = tmp_path / "s.npz"
    main(["build-map", str(d_map), "-o", str(out), "--stream", "--chunk", "3",
          "--workdir", str(tmp_path / "w"), *MAP_ARGS])
    rec = _last_json(capsys.readouterr().out)
    assert rec["registered"] >= 7 and rec["points"] > 100
    with pytest.raises(SystemExit):
        main(["build-map", str(d_map), "-o", str(out), "--stream", "--video", *MAP_ARGS])


def test_cli_georeference(image_dirs, built, tmp_path, capsys):
    _, _, poses = image_dirs
    out = built[0]
    from sfmx_torch.mapstore.scene import load_scene

    scene = load_scene(out, "cpu")
    alive = np.flatnonzero(scene.cam_alive.numpy())[:4]
    ctrl = [[int(c), *poses[int(c)][2].tolist()] for c in alive]
    ctrl_f = tmp_path / "ctrl.json"
    ctrl_f.write_text(json.dumps(ctrl))
    main(["georeference", str(out), str(ctrl_f), "-o", str(tmp_path / "geo2.npz"),
          "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["control_rmse"] < 0.1
    # the whole trajectory is now in world coordinates
    scene2 = load_scene(tmp_path / "geo2.npz", "cpu")
    centers = scene2.centers.numpy()
    gt = np.stack([poses[i][2] for i in range(8)])
    a2 = scene2.cam_alive.numpy()
    err = np.linalg.norm(centers[a2] - gt[a2[:8].nonzero()[0]], axis=1)
    assert np.median(err) < 0.15


def test_cli_merge_and_export(image_dirs, tmp_path, capsys):
    """Two overlapping sessions (frames 0-5, 2-7) built and merged; the
    merged store exported to PLY."""
    d_map, _, poses = image_dirs
    stores = []
    for i, (lo, hi) in enumerate(((0, 6), (2, 8))):
        d = tmp_path / f"sess{i}"
        d.mkdir()
        for j in range(lo, hi):
            shutil.copy(d_map / f"f{j:03d}.png", d / f"f{j:03d}.png")
        stores.append(str(tmp_path / f"s{i}.npz"))
        main(["build-map", str(d), "-o", stores[-1], *MAP_ARGS])
        assert _last_json(capsys.readouterr().out)["registered"] >= 5
    merged = tmp_path / "merged.npz"
    main(["merge", *stores, "-o", str(merged), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["n_cameras"] == 12 and not rec["failed_edges"]
    from sfmx_torch.mapstore.scene import load_scene
    from sfmx_torch.solvers import umeyama

    scene = load_scene(merged, "cpu")
    eyes = torch.as_tensor(np.stack([poses[j][2] for j in [*range(0, 6), *range(2, 8)]]),
                           dtype=torch.float32)
    ate = float(umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)[0])
    assert ate < 0.1, ate

    ply = tmp_path / "merged.ply"
    main(["export", str(merged), "-o", str(ply), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    n_pts, n_cams = int(scene.X_alive.sum()), int(scene.cam_alive.sum())
    assert rec["vertices"] == n_pts + 5 * n_cams and ply.exists()
    assert rec["edges"] == 8 * n_cams + (n_cams - 1)


def test_cli_bundle_unbundle(tmp_path, capsys):
    """Deploy bundle: the map artifacts round trip (no compile cache)."""
    m = tmp_path / "mymap"
    m.mkdir()
    (m / "arrays.npz").write_bytes(b"x" * 64)
    (tmp_path / "mymap.feats.npz").write_bytes(b"y" * 64)
    lm = tmp_path / "mymap.lmap"
    lm.mkdir()
    (lm / "vocab.npy").write_bytes(b"z" * 64)

    out = tmp_path / "deploy.tar.gz"
    main(["bundle", str(m), "-o", str(out), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["map_artifacts"] == 3 and "cached_programs" not in rec
    assert out.exists()
    with pytest.raises(SystemExit):  # no compile-cache flags in the port
        main(["bundle", str(m), "-o", str(out), "--cache", str(tmp_path)])

    dest = tmp_path / "deployed"
    main(["unbundle", str(out), "-d", str(dest), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert len(rec["maps"]) == 1 and "cache" not in rec
    mp = rec["maps"][0]
    assert open(os.path.join(mp, "arrays.npz"), "rb").read() == b"x" * 64
    assert open(mp + ".feats.npz", "rb").read() == b"y" * 64
    assert open(os.path.join(mp + ".lmap", "vocab.npy"), "rb").read() == b"z" * 64
    with pytest.raises(SystemExit):
        main(["bundle", str(tmp_path / "nothing"), "-o", str(out), "--device", "cpu"])


def test_cli_evaluate_and_georeference_match_reference(image_dirs, built, tmp_path, capsys):
    """The port's evaluate and georeference against sfmx's command bodies
    on the same store."""
    from sfmx.cli import main as jmain

    _, _, poses = image_dirs
    out = built[0]
    ref_txt = tmp_path / "centers.txt"
    np.savetxt(ref_txt, np.stack([poses[i][2] for i in range(8)]))
    main(["evaluate", str(out), "--reference", str(ref_txt), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    jmain.cmd_evaluate(argparse.Namespace(map=str(out), reference=str(ref_txt)))
    want = json.loads(capsys.readouterr().out)
    for part in ("scene", "trajectory"):
        for k, v in want[part].items():
            assert got[part][k] == pytest.approx(v, rel=0, abs=1e-5), (part, k)

    from sfmx_torch.mapstore.scene import load_scene_np

    alive = np.flatnonzero(load_scene_np(out)["cam_alive"])[:4]
    ctrl_f = tmp_path / "ctrl.json"
    ctrl_f.write_text(json.dumps([[int(c), *poses[int(c)][2].tolist()] for c in alive]))
    recs = []
    for name, run in (("port", lambda o: main(["georeference", str(out), str(ctrl_f), "-o", o,
                                                "--device", "cpu"])),
                      ("ref", lambda o: jmain.cmd_georeference(argparse.Namespace(
                          map=str(out), control=str(ctrl_f), output=o)))):
        run(str(tmp_path / f"geo_{name}.npz"))
        recs.append(json.loads(capsys.readouterr().out))
    assert recs[0]["scale"] == pytest.approx(recs[1]["scale"], rel=1e-5)
    assert recs[0]["control_rmse"] == pytest.approx(recs[1]["control_rmse"], rel=0, abs=1e-5)
    a, b = (load_scene_np(tmp_path / f"geo_{n}.npz") for n in ("port", "ref"))
    extent = float(np.abs(b["X"][b["X_alive"]]).max())
    for k in ("cam_R", "cam_t", "X"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * max(extent, 1.0), err_msg=k)


def _extract_records(err: str) -> list[dict]:
    recs = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    return [r for r in recs if r.get("stage") == "extract"]


def test_localize_logs_the_reference_extract_record(image_dirs, built, capsys):
    """One ``localize`` call of each package on one store writes one
    ``extract`` record, with the same keys and the same image count and
    extractor (the port's localize extracts through ``extract_features``;
    its service extracts through ``_extract_raw`` and writes no record)."""
    from sfmx.cli import main as jmain

    _, d_q, _ = image_dirs
    out = built[0]
    main(["localize", str(out), str(d_q), *MAP_ARGS])
    got = _extract_records(capsys.readouterr().err)
    overrides = [MAP_ARGS[i + 1] for i, a in enumerate(MAP_ARGS) if a == "-D"]
    jmain.cmd_localize(argparse.Namespace(
        map=str(out), images=str(d_q), video=False, every_n=10, sequential=False, radius=3.0,
        config=None, override=overrides))
    want = _extract_records(capsys.readouterr().err)
    assert len(got) == 1 and len(want) == 1, (got, want)
    assert set(got[0]) == set(want[0])
    for k in ("n_images", "extractor"):
        assert got[0][k] == want[0][k], k
    assert got[0]["n_images"] == 2
    assert got[0]["keypoints"] > 0
