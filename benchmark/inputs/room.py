"""The benchmark's seeded room: geometry, colour, cameras and ray-cast
images, made by the benchmark itself (the program renders none of them).

The geometry and the procedural `texture` are frozen copies of the port's
`scene/synthetic.py` (itself the layout of tools/make_synthetic_scene.py):
a box of half extents ROOM_HALF with four spheres inside, coloured by a
multi-octave sine texture whose directions and frequencies come from the
seed. Images and depths are ray-cast exactly from that surface (first hit
of each pixel's ray on the box or a sphere), on the device, so that no
renderer of the program makes the inputs it is judged on.

Cameras follow the port's orbit (OpenCV convention, an interior ellipse
looking out at the walls). A pixel p sees the ray through the screen point
the rasterizer maps to p: ndc x = (2 p + 1) / W - 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ROOM_HALF = (2.0, 1.4, 2.0)
SPHERES = (((-0.8, -0.9, -0.6), 0.45), ((0.9, -0.8, 0.5), 0.35), ((0.0, -1.0, 1.1), 0.3),
           ((-0.3, -0.5, 0.9), 0.25))
# (axis, sign, share of the walls' points relative to one tenth of the total)
WALLS = ((0, -1, 1.0), (0, 1, 1.0), (1, -1, 1.5), (1, 1, 1.5), (2, -1, 1.0), (2, 1, 1.0))


class Room(NamedTuple):
    seed_vecs: np.ndarray  # (9, 5) texture directions, frequencies, phases


def make_room(rng: np.random.Generator) -> Room:
    seed_vecs = rng.uniform(-1, 1, (9, 5)).astype(np.float32)
    seed_vecs[:, 3] = rng.uniform(2.0, 9.0, 9)  # spatial frequencies
    return Room(seed_vecs)


def texture(p: torch.Tensor, seed_vecs: np.ndarray) -> torch.Tensor:
    """Multi-octave procedural colour of points (..., 3) -> (..., 3) in [0, 1]."""
    c = torch.zeros(p.shape[:-1] + (3,), dtype=torch.float32, device=p.device)
    for k, v in enumerate(seed_vecs.tolist()):
        phase = p @ torch.tensor(v[:3], dtype=torch.float32, device=p.device)
        c[..., k % 3] += 0.5 + 0.5 * torch.sin(phase * v[3] + v[4])
    c /= max(len(seed_vecs) / 3.0, 1.0)
    return torch.clamp(c, 0.02, 0.98)


def surface_points(rng: np.random.Generator, n: int):
    """n points on the room's surfaces (walls, then spheres) and the
    surface density of each (points per square metre)."""
    half = np.array(ROOM_HALF, np.float32)
    per_wall = n // 10
    pts, dens = [], []
    for axis, sign, frac in WALLS:
        k = int(per_wall * frac)
        p = rng.uniform(-1, 1, (k, 3)).astype(np.float32) * half
        p[:, axis] = sign * half[axis]
        other = [a for a in range(3) if a != axis]
        area = 4.0 * half[other[0]] * half[other[1]]
        pts.append(p)
        dens.append(np.full(k, k / area, np.float32))
    n_obj = n - sum(len(p) for p in pts)
    per_obj = n_obj // len(SPHERES)
    for i, (c, r) in enumerate(SPHERES):
        k = per_obj + (n_obj - per_obj * len(SPHERES) if i == len(SPHERES) - 1 else 0)
        d = rng.normal(size=(k, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        pts.append(np.asarray(c, np.float32) + d * r)
        dens.append(np.full(k, k / (4 * math.pi * r * r), np.float32))
    return np.concatenate(pts), np.concatenate(dens)


def orbit_c2ws(n_cams: int, phase: float = 0.0) -> np.ndarray:
    """c2w matrices (OpenCV convention) on the port's interior ellipse,
    looking out at the walls with a slow vertical nod; `phase` turns the
    orbit's start."""
    c2ws = []
    for i in range(n_cams):
        t = i / n_cams * 2 * math.pi + phase
        pos = np.array([0.9 * math.cos(t), -0.15 + 0.25 * math.sin(2 * t), 0.9 * math.sin(t)], np.float32)
        look = np.array([2.2 * math.cos(t + 0.35), 0.2 * math.sin(t * 3), 2.2 * math.sin(t + 0.35)], np.float32)
        fwd = look - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0, -1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, upv, fwd, pos
        c2ws.append(c2w)
    return np.stack(c2ws)


def fovs(width: int, height: int, hfov_deg: float):
    fovx = math.radians(hfov_deg)
    return fovx, 2 * math.atan(math.tan(fovx / 2) * height / width)


@torch.no_grad()
def raycast(room: Room, c2w: np.ndarray, width: int, height: int, hfov_deg: float, device):
    """(image (H, W, 3) in [0, 1], z-depth (H, W)) of one camera."""
    fovx, fovy = fovs(width, height, hfov_deg)
    dev = torch.device(device)
    xs = ((2 * torch.arange(width, device=dev, dtype=torch.float32) + 1) / width - 1) * math.tan(fovx / 2)
    ys = ((2 * torch.arange(height, device=dev, dtype=torch.float32) + 1) / height - 1) * math.tan(fovy / 2)
    d_cam = torch.stack([xs[None, :].expand(height, width), ys[:, None].expand(height, width),
                         torch.ones((height, width), device=dev)], dim=-1)
    rot = torch.tensor(c2w[:3, :3], dtype=torch.float32, device=dev)
    o = torch.tensor(c2w[:3, 3], dtype=torch.float32, device=dev)
    d = d_cam @ rot.T  # world direction, z-component 1 in the camera
    half = torch.tensor(ROOM_HALF, dtype=torch.float32, device=dev)
    # the box seen from inside: the face ahead on each axis
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_axes = (torch.sign(safe) * half - o) / safe
    t_hit = t_axes.min(dim=-1).values
    for c, r in SPHERES:
        oc = o - torch.tensor(c, dtype=torch.float32, device=dev)
        a = (d * d).sum(-1)
        b = (d * oc).sum(-1)
        disc = b * b - a * (oc @ oc - r * r)
        t_s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
        t_hit = torch.where((disc > 0) & (t_s > 0) & (t_s < t_hit), t_s, t_hit)
    p = o + d * t_hit[..., None]
    return texture(p, room.seed_vecs), t_hit  # d_cam.z = 1: t is the z-depth
