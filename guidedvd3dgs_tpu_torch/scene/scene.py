"""Scene container: camera lists, the initial Gaussians, model snapshots.

Counterpart of `guidedvd3dgs_tpu/scene/scene.py`, with the port's own
dataset readers, cameras and Gaussians.
"""

from __future__ import annotations

import json
import os
import shutil
import types
from typing import List, Optional

import numpy as np

from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams, GaussianState, create_from_pcd
from guidedvd3dgs_tpu_torch.scene import dataset_readers
from guidedvd3dgs_tpu_torch.scene.ply import save_gaussian_ply
from guidedvd3dgs_tpu_torch.scene.camera_utils import camera_list_from_infos, camera_to_json
from guidedvd3dgs_tpu_torch.scene.cameras import Camera


def searchForMaxIteration(folder: str) -> int:
    iters = [int(f.split("_")[-1]) for f in os.listdir(folder) if f.startswith("iteration_")]
    return max(iters)


class Scene:
    def __init__(self, args, load_iteration: Optional[int] = None, replica_use_project_cam: bool = False,
                 projected_dir: Optional[str] = None):
        """`load_iteration` -1 picks the newest `point_cloud/iteration_*`
        snapshot of `args.model_path`; None loads no snapshot and records
        the input point cloud and cameras.json there, as a new run does.
        A COLMAP scene (`sparse/`) is read by its `args.dataset`, a
        directory with `transforms_train.json` as a Blender scene; with
        `replica_use_project_cam` (or the flag in `args`) a Replica scene
        also has projection cameras, their projections read from
        `projected_dir`."""
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = searchForMaxIteration(
                    os.path.join(self.model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if os.path.exists(os.path.join(args.source_path, "sparse")):
            scene_info = dataset_readers.read_colmap_scene(
                args.source_path,
                args.images,
                args.dataset,
                args.eval,
                n_views=args.n_views,
                ply_path=getattr(args, "dust3r_ply", ""),
                replica_use_project_cam=replica_use_project_cam
                or getattr(args, "replica_use_project_cam", False),
                projected_dir=projected_dir,
                demo_setting=getattr(args, "demo_setting", False),
            )
        elif os.path.exists(os.path.join(args.source_path, "transforms_train.json")):
            scene_info = dataset_readers.read_blender_scene(args.source_path, args.white_background, args.eval)
        else:
            raise ValueError(f"Could not recognize scene type at {args.source_path}")
        self.scene_info = scene_info
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras: List[Camera] = camera_list_from_infos(scene_info.train_cameras, 1.0, args)
        self.test_cameras: List[Camera] = camera_list_from_infos(scene_info.test_cameras, 1.0, args)
        self.project_cameras: List[Camera] = camera_list_from_infos(scene_info.project_cameras or [], 1.0,
                                                                    args)

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if os.path.exists(scene_info.ply_path):
                shutil.copyfile(scene_info.ply_path, os.path.join(self.model_path, "input.ply"))
            cams = self.train_cameras + self.test_cameras
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

    def _ply_path(self, iteration: int) -> str:
        return os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")

    def load_gaussians(self, iteration: int, device) -> GaussianParams:
        return GaussianParams.from_ply(self._ply_path(iteration), device)

    def create_gaussians(self, max_sh_degree: int = 3, use_color: bool = True,
                         device="cpu") -> GaussianState:
        """The initial training state: from the scene's point cloud, or the
        loaded snapshot when load_iteration was given."""
        if self.loaded_iter:
            return GaussianState.fresh(self.load_gaussians(self.loaded_iter, device))
        pcd = self.scene_info.point_cloud
        return create_from_pcd(np.asarray(pcd.points, np.float32), np.asarray(pcd.colors, np.float32),
                               max_sh_degree=max_sh_degree, use_color=use_color, device=device)

    def save(self, iteration: int, state: GaussianState) -> None:
        """Write point_cloud/iteration_<iteration>/point_cloud.ply."""
        arrays = {k: v.cpu().numpy() for k, v in state.params.tensors().items()}
        save_gaussian_ply(self._ply_path(iteration), types.SimpleNamespace(**arrays),
                          np.ones(state.num_gaussians, bool))

    def getTrainCameras(self) -> List[Camera]:
        return self.train_cameras

    def getTestCameras(self) -> List[Camera]:
        return self.test_cameras

    def getProjectCameras(self) -> List[Camera]:
        return self.project_cameras
