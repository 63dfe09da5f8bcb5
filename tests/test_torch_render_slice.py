"""The serving slice end to end, port against reference, on the CPU.

A tiny synthetic scene (2,000 Gaussians, 64x48, 3 train + 3 test views)
is written in the tools/make_synthetic_scene.py layout. The reference runs
in-process (Scene + eval_render with the dense oracle + its metrics.py);
the port runs `guidedvd3dgs_tpu_torch.render.main` + `metrics.evaluate` on
device "cpu". The 8-bit renders agree within 1 level everywhere and are
identical on >= 99.9% of pixels; PSNR agrees within 1e-3 dB and SSIM
within 1e-5.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import torch

from guidedvd3dgs_tpu.config import ModelParams, build_parser, get_combined_args
from guidedvd3dgs_tpu.scene import cameras as jax_cameras
from guidedvd3dgs_tpu.scene.colmap import qvec2rotmat
from guidedvd3dgs_tpu.scene.scene import Scene as JaxScene
from guidedvd3dgs_tpu.utils.losses import l1_loss as jax_l1_loss
from guidedvd3dgs_tpu.utils.losses import psnr as jax_psnr
from guidedvd3dgs_tpu.utils.losses import ssim as jax_ssim
from guidedvd3dgs_tpu_torch import metrics as port_metrics
from guidedvd3dgs_tpu_torch import render as port_render
from guidedvd3dgs_tpu_torch.convert import params_from_numpy
from guidedvd3dgs_tpu_torch.models.render import eval_render
from guidedvd3dgs_tpu_torch.scene import cameras, synthetic
from guidedvd3dgs_tpu_torch.scene.scene import Scene
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss, psnr, ssim

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ITER = 100


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}_cli", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tiny_scene(tmp_path):
    rng = np.random.default_rng(3)
    gt = synthetic.room_gaussians(2000, rng)
    c2ws, cams = synthetic.orbit(6, 64, 48, 90.0, rng)
    gt_params = params_from_numpy(gt)
    bg = torch.zeros(3)
    images = [eval_render(gt_params, c.raster_camera("cpu"), bg, 3).color.clamp(0, 1).numpy()
              for c in cams]
    model = {k: v.copy() for k, v in gt.items()}
    model["features_dc"] += rng.normal(scale=0.15, size=model["features_dc"].shape).astype(np.float32)
    model["opacity"] += rng.normal(scale=0.3, size=model["opacity"].shape).astype(np.float32)
    src, mdl = tmp_path / "scene", tmp_path / "model_port"
    synthetic.write_scene(str(src), str(mdl), c2ws, cams, images, model,
                          [0, 2, 4], [1, 3, 5], ITER, rng)
    return src, mdl


def _reference_slice(model_dir):
    ref_render = _load_root_module("render")
    ref_metrics = _load_root_module("metrics")
    args = get_combined_args(build_parser(fill_none=True).parse_args(["-m", str(model_dir)]))
    dataset = ModelParams.extract(args)
    scene = JaxScene(dataset, load_iteration=-1)
    state = scene.create_gaussians(max_sh_degree=dataset.sh_degree)
    tl = {"state": state, "bg": jnp.zeros(3), "sh_degree": dataset.sh_degree, "backend": "dense"}
    for name, views in (("train", scene.getTrainCameras()), ("test", scene.getTestCameras())):
        ref_render.render_set(str(model_dir), name, scene.loaded_iter, views, tl)
    ref_metrics.evaluate([str(model_dir)])


def test_render_and_metrics_match_reference(tmp_path):
    src, port_dir = _write_tiny_scene(tmp_path)
    ref_dir = tmp_path / "model_ref"
    shutil.copytree(port_dir, ref_dir)

    port_render.main(["-m", str(port_dir), "--device", "cpu"])
    port_metrics.evaluate([str(port_dir)], device="cpu")
    _reference_slice(ref_dir)

    n_png = 0
    for split in ("train", "test"):
        for sub in ("renders", "gt"):
            pdir = port_dir / split / f"ours_{ITER}" / sub
            rdir = ref_dir / split / f"ours_{ITER}" / sub
            names = sorted(p.name for p in rdir.iterdir())
            assert names == sorted(p.name for p in pdir.iterdir()) and len(names) == 3
            for name in names:
                a = cv2.imread(str(pdir / name)).astype(np.int32)
                b = cv2.imread(str(rdir / name)).astype(np.int32)
                diff = np.abs(a - b)
                assert diff.max() <= 1, (split, sub, name)
                assert (diff == 0).mean() >= 0.999, (split, sub, name, (diff == 0).mean())
                n_png += 1
                if sub == "renders":
                    assert a.std() > 5  # a real render, not a constant image
    assert n_png == 12

    port_res = json.loads((port_dir / "results.json").read_text())[f"ours_{ITER}"]
    ref_res = json.loads((ref_dir / "results.json").read_text())[f"ours_{ITER}"]
    assert abs(port_res["PSNR"] - ref_res["PSNR"]) < 1e-3
    assert abs(port_res["SSIM"] - ref_res["SSIM"]) < 1e-5
    assert 15.0 < port_res["PSNR"] < 60.0
    assert port_res["LPIPS"] is None and port_res["LPIPS_ALEX"] is None
    per_view = json.loads((port_dir / "per_view.json").read_text())[f"ours_{ITER}"]
    assert sorted(per_view["PSNR"]) == ["00000.png", "00001.png", "00002.png"]


def test_losses_match_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        float(ssim(ta, tb)), float(jax_ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-6
    )
    np.testing.assert_allclose(
        float(psnr(ta, tb)[0, 0]), float(jax_psnr(jnp.asarray(a), jnp.asarray(b))[0, 0]), atol=1e-4
    )
    np.testing.assert_allclose(
        float(l1_loss(ta, tb)), float(jax_l1_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6
    )


def test_new_scene_records_cameras_like_reference(tmp_path):
    """Without a snapshot to load, both Scenes record the input point
    cloud and cameras.json in the model directory."""
    src, _ = _write_tiny_scene(tmp_path)
    out = {}
    for name, scene_cls in (("port", Scene), ("ref", JaxScene)):
        args = ModelParams(source_path=str(src), model_path=str(tmp_path / name),
                           dataset="colmap", n_views=3)
        scene = scene_cls(args, load_iteration=None)
        assert scene.loaded_iter is None and len(scene.getTestCameras()) == 3
        out[name] = json.loads((tmp_path / name / "cameras.json").read_text())
        assert (tmp_path / name / "input.ply").read_bytes() == (src / "sparse/0/points3D.ply").read_bytes()
    assert len(out["port"]) == 6
    for p, r in zip(out["port"], out["ref"]):
        assert {k: p[k] for k in ("id", "img_name", "width", "height")} == \
            {k: r[k] for k in ("id", "img_name", "width", "height")}
        for k in ("position", "rotation", "fx", "fy"):
            np.testing.assert_allclose(p[k], r[k], rtol=1e-12)


def test_cameras_match_reference():
    rng = np.random.default_rng(8)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R, T = qvec2rotmat(q).T, rng.normal(size=3)
    img = np.zeros((3, 30, 40), np.float32)
    pc = cameras.Camera(colmap_id=1, R=R, T=T, FoVx=1.1, FoVy=0.9, image=img)
    rc = jax_cameras.Camera(colmap_id=1, R=R, T=T, FoVx=1.1, FoVy=0.9, image=img)
    for k in ("world_view_transform", "projection_matrix", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(rc, k), err_msg=k)
    port_rc, ref_rc = pc.raster_camera("cpu"), rc.raster_camera()
    np.testing.assert_array_equal(port_rc.projmatrix.numpy(), np.asarray(ref_rc.projmatrix))
    assert (port_rc.tanfovx, port_rc.height, port_rc.width) == (ref_rc.tanfovx, 30, 40)

    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = qvec2rotmat(q), T
    K = np.array([[50.0, 0, 20], [0, 45.0, 15], [0, 0, 1]])
    p = cameras.camera_from_w2c_K(w2c, K, 30, 40)
    r = jax_cameras.camera_from_w2c_K(w2c, K, 30, 40)
    np.testing.assert_array_equal(p.full_proj_transform, r.full_proj_transform)
    assert (p.FoVx, p.FoVy, p.image_width, p.image_height) == (r.FoVx, r.FoVy, 40, 30)
