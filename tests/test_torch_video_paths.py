"""The flythrough paths and `render.py --video`, port against reference, on the CPU.

  - `vendored/multinerf_paths.py` (through `utils/pose_paths.py`): the
    ellipse path of seeded camera poses, the spiral of a seeded LLFF
    poses_bounds array and `sample_np` (deterministic, centred, jittered
    from a seeded global stream) equal the JAX package's exactly (the same
    numpy code).
  - `render --video` on a tiny scene (make_scene at 48x64, its iteration-0
    model), with cv2 absent: 240 PNG frames, each bitwise the quantised
    `eval_render` of its camera; the cameras those of the reference's
    render_video (the same w2c and K).
"""

import os
import sys

import numpy as np
import torch

from guidedvd3dgs_tpu.scene.cameras import camera_from_w2c_K as jax_camera_from_w2c_K
from guidedvd3dgs_tpu.utils import pose_paths as jpaths
from guidedvd3dgs_tpu_torch import render as port_render
from guidedvd3dgs_tpu_torch.config import ModelParams, build_parser, save_cfg_args
from guidedvd3dgs_tpu_torch.models.render import eval_render
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.utils import pose_paths as ppaths
from guidedvd3dgs_tpu_torch.utils.image_io import read_png
from guidedvd3dgs_tpu_torch.utils.video import video_u8

torch.set_num_threads(2)


class _View:
    def __init__(self, R, T):
        self.R, self.T = R, T


def test_ellipse_spiral_and_sample_np_match_reference():
    rng = np.random.default_rng(13)
    c2ws, cams = synthetic.orbit(17, 64, 48, 80.0, rng)
    views = [_View(c.R, c.T) for c in cams]
    for n in (240, 31):
        np.testing.assert_array_equal(np.stack(ppaths.generate_ellipse_path(views, n_frames=n)),
                                      np.stack(jpaths.generate_ellipse_path(views, n_frames=n)))
    poses = np.concatenate([rng.normal(size=(9, 15)), rng.uniform(1.0, 8.0, (9, 2))], 1)
    poses[:, :15] += np.tile(np.eye(3, 5).ravel(), 1)
    np.testing.assert_array_equal(ppaths.generate_spiral_path(poses, n_frames=240),
                                  jpaths.generate_spiral_path(poses, n_frames=240))
    t = np.sort(rng.uniform(0, 5, 12))
    w = rng.normal(size=11)
    for kw in (dict(rand=False), dict(rand=False, deterministic_center=True),
               dict(rand=True), dict(rand=True, single_jitter=True)):
        np.random.seed(5)
        got = ppaths.sample_np(t=t, w_logits=w, num_samples=9, **kw)
        np.random.seed(5)
        want = jpaths.sample_np(t=t, w_logits=w, num_samples=9, **kw)
        np.testing.assert_array_equal(got, want)


def test_render_video_writes_240_frames_of_eval_render(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the PNG-frame writer
    src, mdl = tmp_path / "scene", tmp_path / "model"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3,
                         device="cpu")
    args = build_parser().parse_args(["-s", str(src), "-m", str(mdl), "--dataset", "colmap", "--n_views", "3",
                                      "--eval"])
    scene = Scene(ModelParams.extract(args))
    scene.save(0, scene.create_gaussians(device="cpu"))
    save_cfg_args(str(mdl), args)
    port_render.main(["-m", str(mdl), "--iteration", "0", "--skip_train", "--skip_test", "--video",
                      "--device", "cpu"])
    frames_dir = mdl / "video" / "ours_0" / "final_video"
    names = sorted(os.listdir(frames_dir))
    assert names == [f"{i:03d}.png" for i in range(240)]

    params = scene.load_gaussians(0, "cpu")
    views = scene.getTrainCameras()
    cams = port_render.video_cameras(views)
    assert len(cams) == 240
    # the reference's cameras: its path of the same views and its K
    h, w = views[0].image_height, views[0].image_width
    K = np.array([[w / (2 * np.tan(views[0].FoVx / 2)), 0, w / 2],
                  [0, h / (2 * np.tan(views[0].FoVy / 2)), h / 2], [0, 0, 1]])
    for i in (0, 77, 239):
        want = jax_camera_from_w2c_K(np.asarray(jpaths.generate_ellipse_path(views, n_frames=240)[i]), K, h, w)
        np.testing.assert_array_equal(cams[i].full_proj_transform, want.full_proj_transform)
    for cam, name in zip(cams, names):
        r = eval_render(params, cam.raster_camera("cpu"), torch.zeros(3), 3)
        np.testing.assert_array_equal(read_png(str(frames_dir / name)), video_u8(r.color[None])[0])
