"""The Gaussian trainer's inputs, made by the benchmark from the seed:
the room (benchmark/inputs/room.py) seen by the Replica camera from `n_views`
train views of its interior orbit, each with its ground-truth image
ray-cast from the room's surface, and the initial Gaussians.

The initial Gaussians stand for the state of a run at its middle, just
after the opacity reset at iteration 3000: `n_gaussians` points on the
room's surfaces with 1 cm noise (the DUSt3R cloud's role), colour the
texture with noise, log-scale from the surface density (the mean squared
distance to 3 neighbours of a uniform surface sample, 2 / (pi rho)) with
seeded jitter, seeded rotations, SH rest coefficients N(0, 0.02), and
opacities at the reset's 0.05 but for a seeded fifth drawn below it (the
ones the next prunes remove).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from inputs import room as R

SH_C0 = 0.28209479177387814


class View(NamedTuple):
    uid: int  # the orbit camera's index
    R: np.ndarray  # (3, 3) world-from-camera rotation (COLMAP, transposed)
    T: np.ndarray  # (3,) world-to-camera translation
    fovx: float
    fovy: float
    image: torch.Tensor  # (3, H, W) ground truth on the device


class Scene(NamedTuple):
    room: R.Room
    views: List[View]
    extent: float
    params: Dict[str, torch.Tensor]  # raw: xyz, features_dc, features_rest, scaling, rotation, opacity


def make_scene(seed: int, cfg: dict, device) -> Scene:
    rng = np.random.default_rng(seed)
    room = R.make_room(rng)
    w, h, n_cams = cfg["width"], cfg["height"], cfg["n_cams"]
    c2ws = R.orbit_c2ws(n_cams)
    fovx, fovy = R.fovs(w, h, cfg["hfov_deg"])
    ids = [int(i) for i in np.linspace(0, n_cams, cfg["n_views"], endpoint=False).astype(int)]
    views = []
    for i in ids:
        img, _ = R.raycast(room, c2ws[i], w, h, cfg["hfov_deg"], device)
        w2c = np.linalg.inv(c2ws[i])
        views.append(View(i, w2c[:3, :3].T.copy(), w2c[:3, 3].copy(), fovx, fovy,
                          img.permute(2, 0, 1).contiguous()))
    centers = c2ws[:, :3, 3][ids]
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=1).max() * 1.1)
    n = cfg["n_gaussians"]
    pts, dens = R.surface_points(rng, n)
    k = (cfg["sh_degree"] + 1) ** 2 - 1
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    xyz = torch.from_numpy(pts).to(dev) + 0.01 * randn(n, 3)
    cols = torch.clamp(R.texture(xyz, room.seed_vecs) + 0.05 * randn(n, 3), 0.0, 1.0)
    log_s = 0.5 * torch.log(2.0 / (math.pi * torch.from_numpy(dens).to(dev)))
    rot = randn(n, 4)
    low = rand(n) < 0.2
    op = torch.where(low, 0.001 + 0.049 * rand(n), torch.full((n,), 0.05, device=dev))
    params = dict(
        xyz=xyz,
        features_dc=((cols - 0.5) / SH_C0)[:, None, :].contiguous(),
        features_rest=0.02 * randn(n, k, 3),
        scaling=log_s[:, None] + 0.6 * rand(n, 3) - 0.3,
        rotation=rot / torch.linalg.norm(rot, dim=1, keepdim=True),
        opacity=torch.log(op / (1.0 - op))[:, None],
    )
    return Scene(room, views, extent, params)
