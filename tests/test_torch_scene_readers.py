"""The port's scene readers and host tools against the JAX package, on the CPU.

Tiny scenes (16x12 images of a seeded orbit, a seeded point cloud), one per
layout the published scripts read: ScanNet++ (`8a20d62ac0`, images under
`dslr/undistorted_images` named by frame number), re10k (a split json),
Replica with projection cameras (`office_3/Sequence_1`, 3 views, the
projections written by the port's `project_pcd_to_views`) and Blender
(RGBA frames). Both packages read each scene; they must agree exactly: the
split, every camera's R, T, fields of view and fid, the loaded images, the
projection images and masks. Also exact: `farthest_point_sampling`,
`pcd2img` (uint8 image and mask), `utils/vis.py` (`make_grid`, OpenCV's
JET table, the saved grid) and `get_avg_results` on fixture results.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import get_avg_results as root_avg
from guidedvd3dgs_tpu.scene import dataset_readers as jreaders
from guidedvd3dgs_tpu.scene import pcd2img as jpcd2img
from guidedvd3dgs_tpu.scene.scene import Scene as JaxScene
from guidedvd3dgs_tpu.utils import vis as jvis
from guidedvd3dgs_tpu_torch import get_avg_results as port_avg
from guidedvd3dgs_tpu_torch import project_pcd_to_views
from guidedvd3dgs_tpu_torch.scene import dataset_readers as preaders
from guidedvd3dgs_tpu_torch.scene import pcd2img as ppcd2img
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.scene.scene import Scene as PortScene
from guidedvd3dgs_tpu_torch.utils import vis as pvis
from guidedvd3dgs_tpu_torch.utils.image_io import read_png

torch.set_num_threads(2)

W, H = 16, 12


def _write_colmap(src, n, images_dir="images", names=None, seed=0, split=None):
    """An orbit of n views at W x H with random images and a 600-point cloud
    of the room."""
    rng = np.random.default_rng(seed)
    c2ws, cams = synthetic.orbit(n, W, H, 90.0, rng)
    images = [rng.uniform(size=(3, H, W)).astype(np.float32) for _ in range(n)]
    pts, cols = synthetic.sample_room(rng, 600)
    train, test = split if split else (None, None)
    synthetic.write_source(str(src), c2ws, cams, images, train, test, pts,
                           (cols * 255).astype(np.uint8), images_dir=images_dir, names=names)
    return str(src)


def _args(src, model, dataset, images="images", n_views=6):
    return types.SimpleNamespace(source_path=src, model_path=str(model), images=images, dataset=dataset,
                                 eval=True, n_views=n_views, resolution=-1, white_background=False)


def _same_info(j, p):
    assert p.image_name == j.image_name and p.image_path == j.image_path
    np.testing.assert_array_equal(p.R, j.R)
    np.testing.assert_array_equal(p.T, j.T)
    assert (p.FovX, p.FovY, p.width, p.height, p.fid) == (j.FovX, j.FovY, j.width, j.height, j.fid)
    assert (p.projected_image_path, p.projected_mask_path) == (j.projected_image_path, j.projected_mask_path)


def _same_scene(js, ps):
    ji, pi = js.scene_info, ps.scene_info
    assert pi.train_indices == ji.train_indices
    for a, b in (("train_cameras", "train_cameras"), ("test_cameras", "test_cameras"),
                 ("all_cameras", "all_cameras")):
        assert len(getattr(pi, a)) == len(getattr(ji, b)), a
        for j, p in zip(getattr(ji, b), getattr(pi, a)):
            _same_info(j, p)
    assert (pi.project_cameras is None) == (ji.project_cameras is None)
    np.testing.assert_array_equal(pi.nerf_normalization["translate"], ji.nerf_normalization["translate"])
    assert pi.nerf_normalization["radius"] == ji.nerf_normalization["radius"]
    for jc, pc in zip(js.getTrainCameras() + js.getTestCameras() + js.getProjectCameras(),
                      ps.getTrainCameras() + ps.getTestCameras() + ps.getProjectCameras()):
        np.testing.assert_array_equal(pc.image, jc.image)
        np.testing.assert_array_equal(pc.full_proj_transform, jc.full_proj_transform)
        for k in ("projected_image", "projected_mask"):
            a, b = getattr(pc, k), getattr(jc, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_scannetpp_layout_matches_reference(tmp_path):
    train = preaders.SCANNETPP_TRAIN_ID["8a20d62ac0"]
    numbers = sorted(set(range(0, 400, 10)) | set(train))
    src = _write_colmap(tmp_path / "scannetpp" / "8a20d62ac0", len(numbers), "dslr/undistorted_images",
                        [f"DSC{k:05d}.png" for k in numbers])
    js = JaxScene(_args(src, tmp_path / "mj", "scannetpp", "dslr/undistorted_images"))
    ps = PortScene(_args(src, tmp_path / "mp", "scannetpp", "dslr/undistorted_images"))
    _same_scene(js, ps)
    assert [numbers[i] for i in ps.scene_info.train_indices] == train
    assert len(ps.getTestCameras()) == len(preaders.scannetpp_test_indices(ps.scene_info.train_indices,
                                                                           len(numbers)))


def test_re10k_layout_matches_reference(tmp_path):
    src = _write_colmap(tmp_path / "re10k", 14, seed=1, split=([2, 7, 11], [0, 4, 9, 13]))
    js = JaxScene(_args(src, tmp_path / "mj", "re10k", n_views=3))
    ps = PortScene(_args(src, tmp_path / "mp", "re10k", n_views=3))
    _same_scene(js, ps)
    assert ps.scene_info.train_indices == [2, 7, 11] and len(ps.getTestCameras()) == 4


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    """office_3/Sequence_1 (its 3-view split needs 316 frames; 330 here),
    images under rgb/, and the port tool's projections of its cloud."""
    root = tmp_path_factory.mktemp("replica")
    src = _write_colmap(root / "office_3" / "Sequence_1", 330, "rgb", [f"rgb_{i}.png" for i in range(330)],
                        seed=2)
    stems = project_pcd_to_views.project_views(src, os.path.join(src, "sparse", "0", "points3D.ply"),
                                               images="rgb")
    return root, src, stems


def test_replica_with_projection_cameras_matches_reference(replica, tmp_path):
    _, src, _ = replica
    proj = os.path.join(src, "projected_dir")
    js = JaxScene(_args(src, tmp_path / "mj", "replica", "rgb", n_views=3), replica_use_project_cam=True,
                  projected_dir=proj)
    ps = PortScene(_args(src, tmp_path / "mp", "replica", "rgb", n_views=3), replica_use_project_cam=True,
                   projected_dir=proj)
    _same_scene(js, ps)
    assert ps.scene_info.train_indices == preaders.REPLICA_TRAIN_IDX_3V["office3_seq1"]
    assert len(ps.getProjectCameras()) == len(js.getProjectCameras()) == 55


def test_every_projection_camera_gets_its_image_and_mask(replica, tmp_path):
    """The port's tool writes what the port's reader reads: <stem>.png and
    <stem>_mask.npy for every 6th camera in the readers' order, so each
    projection camera carries both (the JAX tool writes <colmap id>.png and
    <id>_mask.png, which its reader does not find as a mask)."""
    _, src, stems = replica
    ps = PortScene(_args(src, tmp_path / "mp", "replica", "rgb", n_views=3), replica_use_project_cam=True,
                   projected_dir=os.path.join(src, "projected_dir"))
    cams = ps.getProjectCameras()
    assert [c.image_name for c in cams] == stems == [f"rgb_{i}" for i in range(0, 330, 6)]
    covered = 0
    for c in cams:
        assert c.projected_image is not None and c.projected_mask is not None, c.image_name
        assert c.projected_image.shape == (3, H, W) and c.projected_mask.shape == (H, W)
        assert set(np.unique(c.projected_mask)) <= {0.0, 1.0}
        # no point lands where the mask is off
        assert not c.projected_image[:, c.projected_mask == 0].any()
        covered += int(c.projected_mask.sum())
    assert covered > 0


def test_blender_layout_matches_reference(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    src = tmp_path / "lego"
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            os.makedirs(src / split, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (H, W, 4), dtype=np.uint8), "RGBA").save(src / split / f"r_{i}.png")
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (src / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    js = JaxScene(_args(str(src), tmp_path / "mj", "blender"))
    ps = PortScene(_args(str(src), tmp_path / "mp", "blender"))
    _same_scene(js, ps)
    assert len(ps.getTrainCameras()) == 3 and len(ps.getTestCameras()) == 2


def test_farthest_point_sampling_matches_reference():
    pts = np.random.default_rng(5).normal(size=(300, 3))
    for seed in (0, 3):
        np.testing.assert_array_equal(preaders.farthest_point_sampling(pts, 25, seed=seed),
                                      jreaders.farthest_point_sampling(pts, 25, seed=seed))


@pytest.mark.parametrize("colors_u8", [False, True])
def test_pcd2img_matches_reference_bitwise(colors_u8):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(4000, 3)) * [2, 1.5, 1] + [0, 0, 4]
    pts[2000:2100] = pts[:100]  # equal depths: the first in the input wins
    cols = rng.uniform(size=(4000, 3)).astype(np.float32)
    if colors_u8:
        cols = (cols * 255).astype(np.uint8)
    K = np.array([[30.0, 0, 32], [0, 30.0, 24], [0, 0, 1]])
    for w2c in (np.eye(4), np.linalg.inv(synthetic.orbit(5, 64, 48, 90.0, rng)[0][3])):
        want = jpcd2img.project_point_cloud_to_image(pts, cols, K, w2c, 64, 48)
        got = ppcd2img.project_point_cloud_to_image(pts, cols, K, w2c, 64, 48)
        for a, b in zip(got, want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_vis_grid_jet_and_plot_match_reference(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    images = rng.uniform(size=(4, 10, 12, 3)).astype(np.float32)
    for pad in (0, 2, 3):
        np.testing.assert_array_equal(pvis.make_grid(images, padding=pad, pad_value=0.5),
                                      jvis.make_grid(images, padding=pad, pad_value=0.5))
    gray = np.linspace(0, 1, 256 * 3).reshape(16, 48)
    np.testing.assert_array_equal(pvis.colormap_jet(gray), jvis.colormap_jet(gray))
    weights = rng.normal(size=(2, 10, 12))
    pvis.plot_images(images, weights, str(tmp_path / "port.png"))
    jvis.plot_images(images, weights, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png"))[:, :, ::-1])


@pytest.mark.parametrize("dataset", ["replica", "scannetpp"])
def test_get_avg_results_matches_the_root_script(tmp_path, dataset):
    rng = np.random.default_rng(9)
    for k, scene in enumerate(port_avg.SCENES[dataset]):
        d = tmp_path / "output" / "exp" / scene
        d.mkdir(parents=True)
        r = {"PSNR": float(rng.uniform(15, 30)), "SSIM": float(rng.uniform(0.5, 1)),
             "LPIPS": None if k == 1 else float(rng.uniform(0, 0.5))}
        r["LPIPS_ALEX" if k % 2 else "LPIPS_alex"] = float(rng.uniform(0, 0.5))
        (d / "results.json").write_text(json.dumps({"ours_10000": r, "ours_30": {}}))
    root = str(tmp_path / "output")
    want = root_avg.evaluate("exp", dataset, 10_000, root)
    want_file = json.loads((tmp_path / "output" / "exp" / "results_allscenes.json").read_text())
    os.remove(tmp_path / "output" / "exp" / "results_allscenes.json")
    got = port_avg.main(["-m", "exp", "--dataset", dataset, "--root", root])
    assert got == want
    assert json.loads((tmp_path / "output" / "exp" / "results_allscenes.json").read_text()) == want_file
