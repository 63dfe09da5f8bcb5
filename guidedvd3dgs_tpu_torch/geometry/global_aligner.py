"""DUSt3R's global alignment (PointCloudOptimizer) in torch autograd.

Counterpart of `guidedvd3dgs_tpu/geometry/global_aligner.py` (the
reference's dust3r/cloud_opt/optimizer.py:16-211, base_opt.py:146-202 and
:346-375). The parameters:

  pw_poses  (E, 8)    per edge: quaternion (xyzw), signed-log T, log scale
  im_poses  (V, 7)    per image: quaternion (xyzw), signed-log T
  im_depth  (V, H*W)  log depth
  im_focals (V,)      focal_break * log(focal)

The loss (optimizer.py:188-202, dist 'l1', conf 'log') is each edge's
log-confidence-weighted distance between the global points (each image's
depth unprojected through its pose and focal) and the pairwise predictions
moved by the edge's pose. `global_align` runs Adam (b1 = b2 = 0.9, eps
1e-8) with the cosine learning rate applied after the update, as the JAX
package's optax chain; preset poses and focals (the guidedvd pipeline
presets both from COLMAP) are not optimised and do not move.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.scene.colmap import rotmat2qvec

ADAM_B1 = 0.9
ADAM_B2 = 0.9
ADAM_EPS = 1e-8


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) in XYZW (roma's convention) -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def rotmat_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    w, x, y, z = rotmat2qvec(R)
    return np.array([x, y, z, w])


def signed_expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def signed_log1p(x):
    return np.sign(x) * np.log1p(np.abs(x))


class AlignerState(NamedTuple):
    pw_poses: torch.Tensor  # (E, 8)
    im_poses: torch.Tensor  # (V, 7)
    im_depth: torch.Tensor  # (V, H*W) log depth
    im_focals: torch.Tensor  # (V,)


@dataclass(frozen=True)
class AlignerConfig:
    height: int
    width: int
    focal_break: float = 20.0
    base_scale: float = 0.5
    min_conf_thr: float = 3.0
    pose_preset: bool = False  # im_poses frozen
    focal_preset: bool = False  # im_focals frozen


def poses_to_rt(poses: torch.Tensor) -> torch.Tensor:
    """(N, >= 7) -> (N, 4, 4) cam-to-world (base_opt.py:146-151)."""
    n = poses.shape[0]
    top = torch.cat([quat_to_rotmat(poses[:, :4]), signed_expm1(poses[:, 4:7])[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=poses.dtype, device=poses.device).expand(n, 1, 4)
    return torch.cat([top, bottom], dim=1)


def pw_rt_scaled(pw_poses: torch.Tensor, base_scale: float, norm_pw_scale: bool = True) -> torch.Tensor:
    """The edge poses with their scale in the upper 3x4 (base_opt.py:174-191;
    the scale's normalisation is off when the poses are preset)."""
    rt = poses_to_rt(pw_poses)
    log_scale = pw_poses[:, -1]
    scale = torch.exp(log_scale)
    if norm_pw_scale:
        scale = scale * torch.exp(math.log(base_scale) - log_scale.mean())
    return torch.cat([rt[:, :3] * scale[:, None, None], rt[:, 3:]], dim=1)


def _pixel_grid(cfg: AlignerConfig, device) -> torch.Tensor:
    yy, xx = torch.meshgrid(torch.arange(cfg.height, device=device), torch.arange(cfg.width, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], -1).reshape(1, -1, 2).to(torch.float32)


def depth_to_pts3d(state: AlignerState, cfg: AlignerConfig) -> torch.Tensor:
    """(V, H*W, 3) world points (optimizer.py:170-186)."""
    dev = state.im_depth.device
    focals = torch.exp(state.im_focals / cfg.focal_break)[:, None, None]
    pp = torch.tensor([cfg.width / 2.0, cfg.height / 2.0], device=dev)
    depth = torch.exp(state.im_depth)[..., None]
    rel = torch.cat([depth * (_pixel_grid(cfg, dev) - pp) / focals, depth], dim=-1)  # (V, HW, 3)
    c2w = poses_to_rt(state.im_poses)
    return torch.einsum("vij,vpj->vpi", c2w[:, :3, :3], rel) + c2w[:, None, :3, 3]


def alignment_loss(state: AlignerState, cfg: AlignerConfig, pred_i: torch.Tensor, pred_j: torch.Tensor,
                   weight_i: torch.Tensor, weight_j: torch.Tensor, edges_i: torch.Tensor,
                   edges_j: torch.Tensor) -> torch.Tensor:
    """optimizer.py:188-202. pred_i / pred_j (E, H*W, 3): views i and j of
    each edge in view i's frame; weight_i / weight_j (E, H*W) the log
    confidences."""
    pts = depth_to_pts3d(state, cfg)
    pw = pw_rt_scaled(state.pw_poses, cfg.base_scale, norm_pw_scale=not cfg.pose_preset)

    def aligned(pred):
        return torch.einsum("eij,epj->epi", pw[:, :3, :3], pred) + pw[:, None, :3, 3]

    area = pred_i.shape[1]
    li = (torch.linalg.norm(pts[edges_i] - aligned(pred_i), dim=-1) * weight_i).sum()
    lj = (torch.linalg.norm(pts[edges_j] - aligned(pred_j), dim=-1) * weight_j).sum()
    return li / (edges_i.shape[0] * area) + lj / (edges_j.shape[0] * area)


def init_state(cfg: AlignerConfig, n_imgs: int, edges: List[Tuple[int, int]], pred_i: np.ndarray,
               rng: np.random.Generator, preset_c2w: np.ndarray = None, preset_focals: np.ndarray = None,
               device="cpu") -> AlignerState:
    """The random start (optimizer.py:29-37) with the preset poses and focals
    (:66-99): each edge's pose seeded at its first view's camera, each
    image's log depth at the z of its first outgoing edge's prediction.
    The draws are JAX's (numpy, in its order)."""
    e = len(edges)
    pw = rng.standard_normal((e, 8)).astype(np.float32)
    ip = rng.standard_normal((n_imgs, 7)).astype(np.float32)
    if preset_c2w is not None:
        for v in range(n_imgs):
            ip[v, :4] = rotmat_to_quat_xyzw(preset_c2w[v][:3, :3])
            ip[v, 4:7] = signed_log1p(preset_c2w[v][:3, 3])
        for eidx, (i, _) in enumerate(edges):
            pw[eidx, :4] = rotmat_to_quat_xyzw(preset_c2w[i][:3, :3])
            pw[eidx, 4:7] = signed_log1p(preset_c2w[i][:3, 3])
            pw[eidx, 7] = 0.0  # log scale 1
    focals = np.full((n_imgs,), cfg.focal_break * np.log(max(cfg.height, cfg.width)), np.float32)
    if preset_focals is not None:
        focals = cfg.focal_break * np.log(np.asarray(preset_focals, np.float32))

    depth = rng.standard_normal((n_imgs, cfg.height * cfg.width)).astype(np.float32) / 10 - 3
    for v in range(n_imgs):
        for eidx, (i, _) in enumerate(edges):
            if i == v:
                z = np.clip(np.asarray(pred_i[eidx][..., 2]).reshape(-1), 1e-4, None)
                depth[v] = np.log(z)
                break

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return AlignerState(pw_poses=t(pw), im_poses=t(ip), im_depth=t(depth), im_focals=t(focals))


def global_align(state: AlignerState, cfg: AlignerConfig, pred_i: torch.Tensor, pred_j: torch.Tensor,
                 conf_i: torch.Tensor, conf_j: torch.Tensor, edges: List[Tuple[int, int]],
                 niter: int = 300, lr: float = 0.01, lr_min: float = 1e-6) -> Tuple[AlignerState, torch.Tensor]:
    """`niter` Adam steps (base_opt.py:346-375): the update m_hat /
    (sqrt(v_hat) + eps) times the cosine lr of step `it`,
    lr_min + (lr - lr_min) (1 + cos(pi it / niter)) / 2. Raw confidences
    enter as their log. Returns (state, the last step's loss)."""
    dev = state.im_depth.device
    weight_i, weight_j = torch.log(conf_i), torch.log(conf_j)
    ei = torch.tensor([i for i, _ in edges], dtype=torch.int64, device=dev)
    ej = torch.tensor([j for _, j in edges], dtype=torch.int64, device=dev)
    frozen = {"im_poses": cfg.pose_preset, "im_focals": cfg.focal_preset}
    names = [n for n in AlignerState._fields if not frozen.get(n, False)]
    params = {n: getattr(state, n).clone().requires_grad_(n in names) for n in AlignerState._fields}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    loss = None
    for it in range(niter):
        cur_lr = lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(it / niter * math.pi))
        loss = alignment_loss(AlignerState(**params), cfg, pred_i, pred_j, weight_i, weight_j, ei, ej)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        bc1 = 1.0 - ADAM_B1 ** (it + 1)
        bc2 = 1.0 - ADAM_B2 ** (it + 1)
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                v[n].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + ADAM_EPS)
                params[n].sub_(cur_lr * upd)
    out = AlignerState(**{n: t.detach() for n, t in params.items()})
    return out, loss.detach()


def aligner_outputs(state: AlignerState, cfg: AlignerConfig) -> dict:
    """get_im_poses / get_focals / get_pts3d / get_depthmaps."""
    pts = depth_to_pts3d(state, cfg)
    v = pts.shape[0]
    return {
        "c2w": poses_to_rt(state.im_poses),
        "focals": torch.exp(state.im_focals / cfg.focal_break),
        "pts3d": pts.reshape(v, cfg.height, cfg.width, 3),
        "depth": torch.exp(state.im_depth).reshape(v, cfg.height, cfg.width),
    }
