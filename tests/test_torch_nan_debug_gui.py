"""--nan_debug and the viewer socket of the port, on the CPU.

  - A NaN planted in xyz during iteration 7 of `train_baseline --nan_debug`
    (densification_interval 5): the run stops with RuntimeError after that
    step and writes `nan_5_7.ckpt`, the state before iteration 6 (bitwise
    the checkpoint a clean run writes at 5, and --start_checkpoint resumes
    it), and `nan_5_7.json`, the schedule of iterations 6 and 7. Run as a
    process on a scene whose point cloud holds a NaN, the CLI exits
    non-zero with `nan_0_1.*` beside the model.
  - JAX's tests/test_network_gui.py round trip with the port's NetworkGUI,
    then one request answered by the port's renderer (`gaussian_render_fn`,
    the tile path on the CPU): the bytes of that render, the verify string,
    and the MiniCam's matrices equal to the JAX package's for the same
    message (view and projection with their y and z columns negated).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.viewer.network_gui import NetworkGUI as JaxGUI
from guidedvd3dgs_tpu_torch import train_baseline as port_train_cli
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.models.render import render_gaussians
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply, store_ply
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer
from guidedvd3dgs_tpu_torch.train.checkpoint import load_checkpoint
from guidedvd3dgs_tpu_torch.utils.graphics import getProjectionMatrix
from guidedvd3dgs_tpu_torch.viewer.network_gui import NetworkGUI, gaussian_render_fn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    src = tmp_path_factory.mktemp("nan") / "scene"
    synthetic.make_scene(str(src), height=24, width=32, n_gt=800, n_init=200, n_cams=8, n_train=3, device="cpu")
    return src


def _args(src, mdl, *extra):
    return ["-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu",
            "--densification_interval", "5", "--densify_from_iter", "1000", "--iterations", "10",
            "--test_iterations", "10", "--save_iterations", "10", *extra]


def test_planted_nan_halts_with_its_bundle(scene, tmp_path, monkeypatch):
    clean = tmp_path / "clean"
    port_train_cli.main(_args(scene, clean, "--checkpoint_iterations", "5"))

    step = BaselineTrainer.step

    def planted(self, iteration):
        out = step(self, iteration)
        if iteration == 7:
            with torch.no_grad():
                self.state.params.xyz[3, 1] = float("nan")
        return out

    monkeypatch.setattr(BaselineTrainer, "step", planted)
    mdl = tmp_path / "nan"
    with pytest.raises(RuntimeError, match="non-finite parameters after iteration 7"):
        port_train_cli.main(_args(scene, mdl, "--nan_debug"))
    bundle = json.loads((mdl / "nan_5_7.json").read_text())
    assert bundle["it0"] == 5 and bundle["it1"] == 7
    assert [s["iteration"] for s in bundle["schedule"]] == [6, 7]
    assert all(s["camera"] and s["xyz_lr"] > 0 for s in bundle["schedule"])
    got = np.load(mdl / "nan_5_7.ckpt")
    want = np.load(clean / "chkpnt5.ckpt")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state, it = load_checkpoint(str(mdl / "nan_5_7.ckpt"))
    assert it == 5 and bool(torch.isfinite(state.params.xyz).all())
    monkeypatch.undo()
    port_train_cli.main(_args(scene, tmp_path / "resumed", "--start_checkpoint", str(mdl / "nan_5_7.ckpt")))


def test_cli_exits_nonzero_on_a_nan_cloud(scene, tmp_path):
    src = tmp_path / "scene"
    shutil.copytree(scene, src)
    ply = src / "sparse" / "0" / "points3D.ply"
    pcd = fetch_ply(str(ply))
    pts = np.asarray(pcd.points, np.float32).copy()
    pts[5, 0] = np.nan
    store_ply(str(ply), pts, (np.asarray(pcd.colors) * 255).astype(np.uint8))
    mdl = tmp_path / "model"
    proc = subprocess.run([sys.executable, "-m", "guidedvd3dgs_tpu_torch.train_baseline",
                           *_args(src, mdl, "--nan_debug")], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0 and "non-finite parameters after iteration 1" in proc.stderr
    assert (mdl / "nan_0_1.ckpt").exists() and (mdl / "nan_0_1.json").exists()


def _message(w, h):
    rng = np.random.default_rng(0)
    view = np.eye(4)
    view[3, :3] = rng.normal(scale=0.1, size=3)  # translation in the transposed layout's last row
    proj = view @ getProjectionMatrix(0.01, 100.0, 1.0, 0.8).T
    view[:, 1:3] *= -1  # the viewer sends the columns negated
    proj[:, 1:3] *= -1
    return {"resolution_x": w, "resolution_y": h, "train": True, "fov_y": 0.8, "fov_x": 1.0,
            "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": [float(x) for x in view.flatten()],
            "view_projection_matrix": [float(x) for x in proj.flatten()]}


def _round_trip(gui, msg, render_fn, verify):
    port = gui.listener.getsockname()[1]
    result = {}

    def client():
        c = socket.create_connection(("127.0.0.1", port))
        payload = json.dumps(msg).encode()
        c.sendall(len(payload).to_bytes(4, "little") + payload)
        want = msg["resolution_x"] * msg["resolution_y"] * 3
        img = b""
        while len(img) < want:
            img += c.recv(want - len(img))
        n = int.from_bytes(c.recv(4), "little")
        result["img"], result["verify"] = img, c.recv(n).decode()
        c.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    for _ in range(200):
        if gui.try_connect():
            break
        time.sleep(0.02)
    else:
        raise AssertionError("client never connected")
    keep = gui.serve_once(render_fn, verify, training=True)
    t.join(timeout=10)
    assert not t.is_alive() and keep
    return result


def test_gui_round_trip_constant_image():
    """JAX's tests/test_network_gui.py on the port's NetworkGUI."""
    gui = NetworkGUI(port=0)
    h, w = 4, 6
    try:
        res = _round_trip(gui, _message(w, h), lambda cam, s: np.full((3, h, w), 0.5, np.float32), "/path/to/scene")
    finally:
        gui.close()
    assert res["verify"] == "/path/to/scene"
    arr = np.frombuffer(res["img"], np.uint8)
    assert arr.shape[0] == h * w * 3 and (arr == 127).all()


def test_gui_answers_a_render_of_the_port():
    rng = np.random.default_rng(1)
    n = 300
    params = GaussianParams.from_arrays({
        "xyz": rng.normal(scale=0.5, size=(n, 3)) + np.array([0, 0, 3.0]),
        "features_dc": rng.normal(scale=0.5, size=(n, 1, 3)), "features_rest": np.zeros((n, 15, 3)),
        "scaling": np.full((n, 3), -2.5), "rotation": np.tile([1.0, 0, 0, 0], (n, 1)),
        "opacity": np.full((n, 1), 1.0)}, "cpu")
    h, w = 24, 32
    msg = _message(w, h)
    seen = {}
    render = gaussian_render_fn(params, 3)

    def render_fn(cam, scaling):
        seen["cam"] = cam
        return render(cam, scaling)

    gui = NetworkGUI(port=0)
    try:
        res = _round_trip(gui, msg, render_fn, "scene")
    finally:
        gui.close()
    cam = seen["cam"]
    # the JAX package's MiniCam of the same message
    jgui = JaxGUI(port=0)
    try:
        jgui.conn = _FakeConn(msg)
        jcam = jgui.receive()[0]
    finally:
        jgui.listener.close()
    np.testing.assert_array_equal(cam.world_view_transform, jcam.world_view_transform)
    np.testing.assert_array_equal(cam.full_proj_transform, jcam.full_proj_transform)
    np.testing.assert_allclose(cam.camera_center, jcam.camera_center, rtol=1e-6)
    with torch.no_grad():
        img = render_gaussians(params, cam.raster_camera("cpu"), torch.zeros(3), 3).color.numpy()
    want = np.clip(img * 255, 0, 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
    assert res["img"] == want and res["verify"] == "scene"
    assert len(set(res["img"])) > 10  # not a blank frame


class _FakeConn:
    """A socket stand-in that yields one length-prefixed message."""

    def __init__(self, msg):
        payload = json.dumps(msg).encode()
        self.buf = len(payload).to_bytes(4, "little") + payload

    def recv(self, n):
        out, self.buf = self.buf[:n], self.buf[n:]
        return out
