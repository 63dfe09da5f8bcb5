"""The SIBR remote viewer's socket protocol.

Counterpart of `guidedvd3dgs_tpu/viewer/network_gui.py` (the reference's
gaussian_renderer/network_gui.py:26-85): a non-blocking TCP listener; a
request is a 4-byte little-endian length and a JSON message (resolution,
fields of view, near and far, the view and view-projection matrices, whose
y and z columns are negated); the answer is the image's raw RGB bytes, then
the length and bytes of the verify string (the scene's source path).
`render_fn(MiniCam, scaling_modifier)` renders the view as (3, H, W) in
[0, 1]; `gaussian_render_fn` builds one on the port's renderer.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.models.render import render_gaussians
from guidedvd3dgs_tpu_torch.scene.cameras import MiniCam


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def close(self) -> None:
        for s in (self.conn, self.listener):
            if s is not None:
                s.close()
        self.conn = None

    def try_connect(self) -> bool:
        try:
            self.conn, addr = self.listener.accept()
        except (BlockingIOError, socket.timeout):
            return False
        print(f"\nConnected by {addr}")
        self.conn.settimeout(None)
        return True

    def _read(self) -> dict:
        n = int.from_bytes(self.conn.recv(4), "little")
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                break
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """(MiniCam or None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier) (network_gui.py:56-85)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, bool(msg.get("train", False)), False, False, False, 1.0
        try:
            view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            view[:, 1] *= -1
            view[:, 2] *= -1
            proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            proj[:, 1] *= -1
            proj[:, 2] *= -1
            cam = MiniCam(width=width, height=height, fovy=msg["fov_y"], fovx=msg["fov_x"],
                          znear=msg["z_near"], zfar=msg["z_far"], world_view_transform=view,
                          full_proj_transform=proj)
        except Exception:
            traceback.print_exc()
            raise
        return (cam, bool(msg["train"]), bool(msg["shs_python"]), bool(msg["rot_scale_python"]),
                bool(msg["keep_alive"]), msg["scaling_modifier"])

    def serve_once(self, render_fn: Callable, source_path: str, training: bool) -> bool:
        """One poll of the viewer loop (the commented-out block of the
        reference's train_baseline.py:227): answer one request if a viewer
        is connected. Returns whether to keep serving; a broken connection
        is dropped (with its traceback) and the next poll listens again."""
        if self.conn is None and not self.try_connect():
            return True
        try:
            cam, _do_training, _shs, _rot, keep_alive, scaling = self.receive()
            img_bytes = None
            if cam is not None:
                img = np.asarray(render_fn(cam, scaling))
                img = np.clip(img * 255, 0, 255).astype(np.uint8)
                img_bytes = np.ascontiguousarray(np.transpose(img, (1, 2, 0))).tobytes()
            self.send(img_bytes, source_path)
            return keep_alive or training
        except (OSError, ValueError, KeyError):
            traceback.print_exc()
            self.conn = None
            return True


def gaussian_render_fn(params, sh_degree: int, bg=(0.0, 0.0, 0.0), backend: str = "auto"):
    """render_fn for `serve_once`: the Gaussians rendered at the viewer's
    camera on their device, (3, H, W) float32 on the host."""
    dev = params.xyz.device
    bg_t = torch.tensor(bg, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def render(cam: MiniCam, scaling_modifier: float = 1.0) -> np.ndarray:
        r = render_gaussians(params, cam.raster_camera(dev), bg_t, sh_degree,
                             scaling_modifier=scaling_modifier, backend=backend)
        return r.color.cpu().numpy()

    return render
