"""The append-pcd path's entry points, port against the JAX package, on
the CPU.

  - The guided CLI with --append_pcd_from_video_diffusion and --dpt_weights
    (a toy-width DPT of tests/test_torch_append_pcd.py written as a torch
    .bin and as a .safetensors with one bf16 tensor; the port's reader
    equals safetensors' own, bf16 widened exactly) lifts points on the
    oracle engine's events; without --dpt_weights it prints JAX's warning
    and the path is off.
  - `python -m guidedvd3dgs_tpu_torch.augment_ply_with_depth` against
    `tools/augment_ply_with_depth.py` on a 3-image COLMAP fixture (one
    image without its triplet, one colour mask): the same ply, bitwise.
"""

import os

import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu_torch import augment_ply_with_depth as port_aug
from guidedvd3dgs_tpu_torch import train_baseline as port_baseline_cli
from guidedvd3dgs_tpu_torch import train_guidedvd as port_guided_cli
from guidedvd3dgs_tpu_torch.dataset_to_colmap import save_cameras_txt, save_images_txt
from guidedvd3dgs_tpu_torch.guidance import dpt as TD
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.scene.ply import fetch_ply, store_ply
from guidedvd3dgs_tpu_torch.utils.image_io import save_image
from tools import augment_ply_with_depth as jax_aug

from test_torch_append_pcd import TOY, toy_params

torch.set_num_threads(2)


def test_cli_dpt_weights_bin_safetensors_and_warning(tmp_path, monkeypatch, capsys):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    src, base = tmp_path / "scene", tmp_path / "baseline"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3,
                         device="cpu")
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu"]
    port_baseline_cli.main(common + ["-m", str(base), "--iterations", "20", "--test_iterations", "20",
                                     "--save_iterations", "20"])
    p = toy_params(3)
    bin_path, st_path = tmp_path / "dpt.bin", tmp_path / "model.safetensors"
    torch.save({k: torch.from_numpy(v) for k, v in p.items()}, str(bin_path))
    sd = {k: torch.from_numpy(v) for k, v in p.items()}
    sd["dpt.embeddings.cls_token"] = sd["dpt.embeddings.cls_token"].to(torch.bfloat16)
    safetensors_torch.save_file(sd, str(st_path))
    got = TD.load_hf_dpt_weights(str(st_path))
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v.float().numpy())
    for k, v in TD.load_hf_dpt_weights(str(bin_path)).items():
        np.testing.assert_array_equal(v, p[k])

    monkeypatch.setattr(port_guided_cli, "DPTConfig", lambda: TD.DPTConfig(**TOY))
    guided = common + ["--baseline_path", str(base), "--baseline_iteration", "20", "--iterations", "24",
                       "--test_iterations", "24", "--save_iterations", "24", "--start_sample_pseudo", "2",
                       "--end_sample_pseudo", "22", "--guidance_vd_iter", "10",
                       "--oracle_gt_npz", str(src / "gt_gaussians.npz"), "--append_pcd_from_video_diffusion"]
    for name, weights in (("bin", bin_path), ("st", st_path)):
        trainer = port_guided_cli.main(guided + ["-m", str(tmp_path / name), "--dpt_weights", str(weights)])
        assert trainer.events_run >= 1 and trainer.points_added > 0  # views without a trajectory skip
        assert trainer.state.num_gaussians > 0 and torch.isfinite(trainer.state.params.xyz).all()
    capsys.readouterr()
    trainer = port_guided_cli.main(guided + ["-m", str(tmp_path / "off")])
    assert "append_pcd_from_video_diffusion needs --dpt_weights" in capsys.readouterr().out
    assert trainer.depth_estimator is None and trainer.points_added == 0


def test_augment_ply_with_depth_matches_jax_tool(tmp_path):
    rng = np.random.default_rng(9)
    sparse = tmp_path / "sparse" / "0"
    os.makedirs(sparse)
    n, h, w = 3, 12, 16
    K = np.array([[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]])
    w2c = np.stack([np.eye(4)] * n)
    w2c[:, :3, 3] = rng.normal(size=(n, 3))
    save_cameras_txt(str(sparse), np.repeat(K[None], n, 0), h, w)
    save_images_txt(str(sparse), w2c)
    store_ply(str(sparse / "points3D.ply"), rng.normal(size=(20, 3)).astype(np.float32),
              rng.integers(0, 255, (20, 3)).astype(np.uint8))
    dirs = {d: tmp_path / d for d in ("rgb", "depth", "mask")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(n - 1):  # the last image has no triplet and is skipped
        save_image(rng.random((h, w, 3)).astype(np.float32), str(dirs["rgb"] / f"{i}.png"))
        np.save(dirs["depth"] / f"{i}.npy", rng.uniform(1, 3, (h, w)))
        m = (rng.random((h, w)) > 0.5).astype(np.float32)
        save_image(np.repeat(m[..., None], 3, -1) if i == 0 else m, str(dirs["mask"] / f"{i}.png"))
    args = dict(ply_path=str(sparse / "points3D.ply"), sparse_dir=str(sparse), rgb_dir=str(dirs["rgb"]),
                depth_dir=str(dirs["depth"]), mask_dir=str(dirs["mask"]), every=1, stride=3)
    n_port = port_aug.augment(out_path=str(tmp_path / "port.ply"), **args)
    n_jax = jax_aug.augment(out_path=str(tmp_path / "jax.ply"), **args)
    assert n_port == n_jax > 20
    a, b = fetch_ply(str(tmp_path / "port.ply")), fetch_ply(str(tmp_path / "jax.ply"))
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.colors, b.colors)
