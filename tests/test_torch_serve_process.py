"""``serve`` as its own process on the CPU: ``python -m sfmx_torch.cli.main
serve --map demo=<store> --port <free port> --device cpu --no-warmup``
started with ``subprocess.Popen`` on a map the port builds at
``test_torch_cli.py``'s small size, PNG queries POSTed one after another
over a real socket on 127.0.0.1, /maps and /stats read, then SIGINT.

The answers are held to the port's in-process service
(``cli.main.make_service`` on the same store, the same requests in the same
order, so the same RANSAC draws: within 1e-3 m, as test_torch_serve.py's
gather-path feature requests) and to the reference's
``LocalizationService`` on the same map arrays (the store read by
``sfmx.cli.main._load_lmap``; its own draws and extraction: within 3 cm and
n_inliers within max(2, 3 %), test_torch_serve.py's image-request
tolerances), every query within 0.2 m of the truth after the map's
similarity.  SIGINT must end the server with exit code 0 and its shutdown
line.  Every wait on the process has a timeout of its own, past which it is
killed.
"""
import asyncio
import base64
import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sfmx_torch.cli.config import load_config
from sfmx_torch.cli.main import main, make_service
from sfmx_torch.serve.server import decode_image_payload

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.room import RoomTexture, render_room, walk_poses  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
GEOMETRY = ["-D", "features.max_keypoints=384", "-D", "match.ratio=0.85",
            "-D", "resize_to=320,240", "-D", "focal_factor=0.875"]
START_S, STOP_S, REQUEST_S = 180, 30, 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(url: str, timeout: float = REQUEST_S):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=REQUEST_S) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """test_torch_cli.py's map (8 room frames, 320x240) built by the port's
    build-map, and 4 held-out query PNGs between its frames."""
    tex = RoomTexture(seed=3)
    poses = walk_poses(10)
    d = tmp_path_factory.mktemp("serve_process")
    (d / "map_imgs").mkdir()
    for i, (R, _t, eye) in enumerate(poses[:8]):
        img = render_room(tex, R, eye, 320, 240, 280.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(d / "map_imgs" / f"f{i:03d}.png")
    q_poses = walk_poses(19)[1:15:4]
    pngs = []
    for R, _t, eye in q_poses:
        buf = io.BytesIO()
        img = render_room(tex, R, eye, 320, 240, 280.0)
        Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="PNG")
        pngs.append(buf.getvalue())
    out = d / "map"
    with contextlib.redirect_stdout(io.StringIO()):
        main(["build-map", str(d / "map_imgs"), "-o", str(out), *GEOMETRY, "--device", "cpu"])
    return dict(path=str(out), pngs=pngs, q_eyes=np.stack([e for _, _, e in q_poses]),
                map_eyes=np.stack([e for _, _, e in poses[:8]]).astype(np.float32), dir=d)


@pytest.fixture(scope="module")
def served(store):
    """The server's answers to the queries, /maps, /stats, its exit code
    after SIGINT and its output lines."""
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out_p = store["dir"] / "serve.out"
    with open(out_p, "w") as fo:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sfmx_torch.cli.main", "serve", "--map",
             f"demo={store['path']}", "--port", str(port), *GEOMETRY, "--device", "cpu",
             "--no-warmup"], cwd=ROOT, env=env, stdout=fo, stderr=subprocess.STDOUT)
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, f"server exited {proc.returncode}:\n{out_p.read_text()}"
            with contextlib.suppress(OSError):
                maps = get(f"{base}/maps", timeout=2)[1]
                break
            assert time.monotonic() - t0 < START_S, "server not answering"
            time.sleep(0.5)
        answers = [post(f"{base}/localize",
                        {"map_id": "demo", "image": base64.b64encode(png).decode()})
                   for png in store["pngs"]]
        stats = get(f"{base}/stats")[1]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=STOP_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(ln) for ln in out_p.read_text().splitlines() if ln.startswith("{")]
    lines = [ln for ln in lines if "serve" in ln]      # the server's own lines
    return dict(maps=maps, answers=answers, stats=stats, rc=rc, lines=lines)


def _in_process(store):
    """The port's own service on the same store, one request at a time."""
    cfg = load_config(None, GEOMETRY[1::2])
    svc = make_service([f"demo={store['path']}"], cfg, "cpu", warmup=False)

    async def go():
        await svc.start()
        try:
            return [await svc.localize("demo", image=decode_image_payload(p, cfg.resize_to))
                    for p in store["pngs"]]
        finally:
            await svc.stop()
    return asyncio.run(go())


def _reference(store):
    """The reference's service on the same map arrays, one request at a time."""
    import jax.numpy as jnp

    from sfmx.cli.config import load_config as jload_config
    from sfmx.cli.main import _load_lmap
    from sfmx.serve.server import LocalizationService as JService
    from sfmx.serve.server import decode_image_payload as jdecode

    cfg = jload_config(None, GEOMETRY[1::2])
    scene, jmap = _load_lmap(store["path"])
    svc = JService(batch_window_ms=5.0, max_batch=32)
    svc.load_map("demo", jmap, jnp.asarray(np.asarray(scene.intr)[0]), cfg=cfg)

    async def go():
        await svc.start()
        try:
            return [await svc.localize("demo", image=jdecode(p, resize_to=cfg.resize_to))
                    for p in store["pngs"]]
        finally:
            await svc.stop()
    return asyncio.run(go())


def _world(store, centers):
    from sfmx_torch.mapstore.scene import load_scene
    from sfmx_torch.solvers import umeyama

    scene = load_scene(store["path"], "cpu")
    eyes = torch.as_tensor(store["map_eyes"], dtype=torch.float32)
    _, sim = umeyama.ate_rmse(scene.centers, eyes, scene.cam_alive)
    return umeyama.apply_sim3(*sim, torch.as_tensor(np.asarray(centers, np.float32))).numpy()


def test_server_process_starts_answers_and_stops(served):
    """/maps lists the map; every POST answers 200; /stats counts every
    request as an image request; SIGINT ends the process with exit code 0
    after its loaded and stopped lines."""
    assert served["maps"] == {"maps": ["demo"]}
    assert all(st == 200 for st, _ in served["answers"])
    n = len(served["answers"])
    assert served["stats"]["requests"] == n and served["stats"]["image_requests"] == n
    assert served["rc"] == 0
    kinds = [ln.get("serve") for ln in served["lines"]]
    assert kinds == ["loaded", "stopped"], served["lines"]
    assert served["lines"][0]["maps"]["demo"][0]["device"] == "cpu"
    assert served["lines"][1]["stats"]["requests"] == n


def test_server_answers_match_in_process_and_reference(store, served):
    """Each answer within 1e-3 m of the in-process service's, within 3 cm of
    the reference service's (n_inliers within max(2, 3 %)), and within
    0.2 m of the truth."""
    got = [o for _, o in served["answers"]]
    local = _in_process(store)
    ref = _reference(store)
    for o, li, r in zip(got, local, ref):
        assert np.linalg.norm(np.subtract(o["center"], li["center"])) <= 1e-3
        assert o["n_inliers"] == li["n_inliers"]
        assert np.linalg.norm(np.subtract(o["center"], r["center"])) < 0.03
        assert abs(o["n_inliers"] - r["n_inliers"]) <= max(2, 0.03 * r["n_inliers"])
    world = _world(store, [o["center"] for o in got])
    errs = np.linalg.norm(world - store["q_eyes"], axis=1)
    assert (errs < 0.2).all(), errs
