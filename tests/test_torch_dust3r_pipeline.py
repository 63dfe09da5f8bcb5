"""DUSt3R's scene pipeline and the raw-data converter, port against the JAX
package, on the CPU.

  - `run_dust3r_scene` on 3 random 32x48 views with the toy network of
    tests/test_torch_dust3r.py (the same numpy weights in both packages),
    poses and focals preset, 30 alignment iterations: the poses and focals
    equal the presets, the per-image confidence (the maximum over edges)
    within 1e-5, depth and points within 1e-3 (30 Adam steps of lr 0.01
    from float32 predictions that agree to 1e-5);
  - `export_colmap` writes a sparse/0 that the port's reader reads back
    (the cameras' poses and field of view, the cloud's points);
  - `python -m guidedvd3dgs_tpu_torch.dataset_to_colmap` on tiny replica,
    scannetpp and re10k fixtures writes cameras.txt and images.txt
    byte-equal to the JAX tool's.
  - The chain from raw data on a 660-frame Replica-layout scene of 32x24
    frames: dataset_to_colmap, then the cloud CLI
    (`python -m guidedvd3dgs_tpu_torch.geometry.pipeline`, the toy network
    written as a DUSt3R .pth with its argparse args, SIZE 48), whose
    points the reader then takes; the 6 train views' poses stay preset.
"""

import argparse
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.geometry import dust3r as JD
from guidedvd3dgs_tpu.geometry import pipeline as JP
from guidedvd3dgs_tpu_torch import dataset_to_colmap as port_d2c
from guidedvd3dgs_tpu_torch.geometry import dust3r as TD
from guidedvd3dgs_tpu_torch.geometry import pipeline as TP
from guidedvd3dgs_tpu_torch.scene.dataset_readers import read_colmap_scene
from guidedvd3dgs_tpu_torch.utils.image_io import save_image
from tools import dataset_to_colmap as jax_d2c

torch.set_num_threads(2)

TOY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4)


def _views(v=3, h=32, w=48):
    rng = np.random.default_rng(4)
    images = rng.random((v, h, w, 3)).astype(np.float32)
    c2w = np.stack([np.eye(4) for _ in range(v)])
    for k in range(v):
        a = 0.2 * k
        c2w[k, :3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
        c2w[k, :3, 3] = [0.3 * k, 0.0, -0.1 * k]
    return images, c2w, np.full(v, 40.0)


@pytest.fixture(scope="module")
def scenes():
    params = TD.init_params(TD.Dust3rConfig(**TOY), seed=5)
    images, c2w, focals = _views()
    js = JP.run_dust3r_scene({k: jnp.asarray(v) for k, v in params.items()}, JD.Dust3rConfig(**TOY), images,
                             known_c2w=c2w, known_focals=focals, niter=30, batch_pairs=4)
    ts = TP.run_dust3r_scene(TD.from_params(params, TD.Dust3rConfig(**TOY)), images, known_c2w=c2w,
                             known_focals=focals, niter=30, batch_pairs=4)
    return js, ts, c2w, focals


def test_run_dust3r_scene_matches_jax(scenes):
    js, ts, c2w, focals = scenes
    np.testing.assert_allclose(ts.c2ws, c2w, atol=1e-5)
    np.testing.assert_allclose(ts.focals, focals, rtol=1e-6)
    np.testing.assert_allclose(ts.confs, js.confs, atol=1e-5)
    np.testing.assert_allclose(ts.depths, js.depths, atol=1e-3)
    np.testing.assert_allclose(ts.pts3d, js.pts3d, atol=1e-3)
    assert ts.pts3d.shape == (3, 32, 48, 3) and np.isfinite(ts.pts3d).all()
    pj, cj = JP.scene_to_pointcloud(js, min_conf_thr=1.0)
    pt, ct = TP.scene_to_pointcloud(ts, min_conf_thr=1.0)
    assert pt.shape == pj.shape and pt.shape[0] == (3 * 32 * 48 + 2) // 3
    np.testing.assert_array_equal(ct, cj)


def test_export_colmap_reads_back(scenes, tmp_path):
    _, ts, c2w, focals = scenes
    scene_dir = tmp_path / "scene"
    n = TP.export_colmap(ts, str(scene_dir / "sparse" / "0"), min_conf_thr=1.0)
    os.makedirs(scene_dir / "images")
    for i, img in enumerate(ts.imgs):
        save_image(img, str(scene_dir / "images" / f"{i}.png"))
    info = read_colmap_scene(str(scene_dir), "images", "colmap", eval=False)
    assert len(info.train_cameras) == 3 and info.point_cloud.points.shape == (n, 3)
    for cam, want in zip(info.train_cameras, c2w):
        w2c = np.linalg.inv(want)
        np.testing.assert_allclose(cam.R.T, w2c[:3, :3], atol=1e-6)
        np.testing.assert_allclose(cam.T, w2c[:3, 3], atol=1e-6)
        assert abs(cam.FovX - 2 * math.atan(48 / (2 * 40.0))) < 1e-6


def _rand_c2w(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q * np.sign(np.linalg.det(q))
    m[:3, 3] = rng.normal(size=3)
    return m


def _fixtures(root):
    rng = np.random.default_rng(6)
    rep = root / "Replica" / "room_0" / "Sequence_2"
    (rep / "rgb").mkdir(parents=True)
    save_image(np.zeros((12, 16, 3), np.float32), str(rep / "rgb" / "rgb_0.png"))
    with open(rep / "traj_w_c.txt", "w") as f:
        for _ in range(4):
            f.write(" ".join(str(x) for x in _rand_c2w(rng).flatten()) + "\n")
    sc = root / "scannetpp" / "8a20d62ac0" / "dslr" / "nerfstudio"
    sc.mkdir(parents=True)
    frames = [{"file_path": f"DSC{i:05d}.JPG", "transform_matrix": _rand_c2w(rng).tolist()} for i in (3, 1, 2)]
    meta = {"fl_x": 30.0, "fl_y": 31.0, "cx": 20.0, "cy": 15.0, "h": 30, "w": 40,
            "frames": frames[:2], "test_frames": frames[2:]}
    (sc / "transforms_undistorted.json").write_text(json.dumps(meta))
    re = root / "re10k" / "scene"
    re.mkdir(parents=True)
    meta = {"fl_x": 50.0, "fl_y": 50.0, "cx": 32.0, "cy": 18.0, "h": 36, "w": 64,
            "frames": [{"transform_matrix": _rand_c2w(rng).tolist()} for _ in range(3)]}
    (re / "transforms.json").write_text(json.dumps(meta))
    return {"replica": (root / "Replica", ["room_0/Sequence_2"]),
            "scannetpp": (root / "scannetpp", ["8a20d62ac0"]), "re10k": (re, [])}


def test_dataset_to_colmap_matches_jax_tool(tmp_path):
    for dataset, (base, scenes) in _fixtures(tmp_path).items():
        path = os.path.join(str(base), scenes[0]) if scenes else str(base)
        argv = [dataset, "--base", str(base)] + (["--scenes", *scenes] if scenes else [])
        assert port_d2c.main(argv) == [path]
        sparse = os.path.join(path, "sparse", "0")
        port_files = {n: open(os.path.join(sparse, n)).read() for n in ("cameras.txt", "images.txt")}
        jax_d2c.convert(dataset, str(base), scenes)
        for n, text in port_files.items():
            assert open(os.path.join(sparse, n)).read() == text, (dataset, n)
        assert len([ln for ln in port_files["cameras.txt"].splitlines() if not ln.startswith("#")]) \
            == {"replica": 4, "scannetpp": 3, "re10k": 3}[dataset]
    assert port_d2c.DEFAULT_SCENES["replica"] == jax_d2c.REPLICA_SCENES
    assert port_d2c.DEFAULT_SCENES["scannetpp"] == jax_d2c.SCANNETPP_SCENES


def test_raw_replica_to_dust3r_cloud_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    scene = tmp_path / "Replica" / "room_0" / "Sequence_2"
    (scene / "rgb").mkdir(parents=True)
    with open(scene / "traj_w_c.txt", "w") as f:
        for i in range(660):
            c2w = np.eye(4)
            c2w[:3, 3] = [0.01 * i, 0.0, 0.0]
            f.write(" ".join(str(x) for x in c2w.flatten()) + "\n")
    for i in range(660):
        save_image(rng.random((24, 32, 3)).astype(np.float32), str(scene / "rgb" / f"rgb_{i}.png"))
    port_d2c.main(["replica", "--base", str(tmp_path / "Replica"), "--scenes", "room_0/Sequence_2"])

    cfg = TD.Dust3rConfig(**TOY)
    sd = {k: torch.from_numpy(v) for k, v in TD.init_params(cfg, seed=2).items()}
    ckpt = tmp_path / "dust3r.pth"
    torch.save({"model": sd, "args": argparse.Namespace(model="toy")}, str(ckpt))
    monkeypatch.setattr(TP, "Dust3rConfig", lambda: cfg)
    monkeypatch.setattr(TP, "SIZE", 48)
    monkeypatch.setattr(TP, "NITER", 10)
    monkeypatch.setattr(TP, "MIN_CONF_THR", 1.0)
    ds, n = TP.main(["-s", str(scene), "--dataset", "replica", "--images", "rgb", "--weights", str(ckpt),
                     "--device", "cpu"])
    assert ds.imgs.shape == (6, 32, 48, 3)  # 32x24 -> 48x36, cropped to multiples of 16
    info = read_colmap_scene(str(scene), "rgb", "replica", eval=True, n_views=6)
    assert info.point_cloud.points.shape == (n, 3) == ((6 * 32 * 48 + 2) // 3, 3)
    assert np.isfinite(info.point_cloud.points).all()
    train = [0.01 * i for i in (5, 80, 187, 392, 497, 658)]
    np.testing.assert_allclose(ds.c2ws[:, 0, 3], train, atol=1e-6)  # the presets did not move
