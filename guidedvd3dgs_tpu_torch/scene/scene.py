"""Scene container: camera lists and model snapshots.

Counterpart of `guidedvd3dgs_tpu/scene/scene.py` on the read path. The
dataset readers are the reference package's (pure numpy); cameras and
Gaussians are the port's.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

from guidedvd3dgs_tpu.scene import dataset_readers
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.scene.camera_utils import camera_list_from_infos, camera_to_json
from guidedvd3dgs_tpu_torch.scene.cameras import Camera


def searchForMaxIteration(folder: str) -> int:
    iters = [int(f.split("_")[-1]) for f in os.listdir(folder) if f.startswith("iteration_")]
    return max(iters)


class Scene:
    def __init__(self, args, load_iteration: Optional[int] = None):
        """`load_iteration` -1 picks the newest `point_cloud/iteration_*`
        snapshot of `args.model_path`; None loads no snapshot and records
        the input point cloud and cameras.json there, as a new run does."""
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

        if not os.path.exists(os.path.join(args.source_path, "sparse")):
            raise ValueError(f"Could not recognize scene type at {args.source_path}")
        scene_info = dataset_readers.read_colmap_scene(
            args.source_path,
            args.images,
            args.dataset,
            args.eval,
            n_views=args.n_views,
            ply_path=getattr(args, "dust3r_ply", ""),
            demo_setting=getattr(args, "demo_setting", False),
        )
        self.scene_info = scene_info
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras: List[Camera] = camera_list_from_infos(scene_info.train_cameras, 1.0, args)
        self.test_cameras: List[Camera] = camera_list_from_infos(scene_info.test_cameras, 1.0, args)

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if os.path.exists(scene_info.ply_path):
                shutil.copyfile(scene_info.ply_path, os.path.join(self.model_path, "input.ply"))
            cams = self.train_cameras + self.test_cameras
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

    def load_gaussians(self, iteration: int, device) -> GaussianParams:
        path = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"
        )
        return GaussianParams.from_ply(path, device)

    def getTrainCameras(self) -> List[Camera]:
        return self.train_cameras

    def getTestCameras(self) -> List[Camera]:
        return self.test_cameras
