"""Gaussian parameters, their activations, and the training state.

Counterpart of `guidedvd3dgs_tpu/models/gaussians.py`. The reference holds
a fixed-capacity state with an `active` mask kept compacted to a prefix
(static shapes under jit); here every tensor has exactly the scene's rows,
so the reference's active prefix is the port's whole tensor, and the row
order is the reference's: appended rows go to the end in index order and
removal is stable, so the two states can be compared row by row.

  * `GaussianParams`: the raw parameters as an `nn.Module` of N rows.
  * `GaussianState`: the parameters, the Adam moments as plain tensors
    (eps 1e-15, one shared step, per-group learning rates; not
    torch.optim, whose state would not follow densification), the
    confidence and the densification statistics.
  * `create_from_pcd`, `adam_step`, `add_densification_stats` (and its
    train + pseudo view form), `update_max_radii`, `densify_and_clone`,
    `densify_and_split`, `proximity`, `densify_and_prune`, `reset_opacity`,
    `add_points`: the reference's operations, updating the state in place
    (and returning it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from guidedvd3dgs_tpu_torch.ops.knn import dist_knn3
from guidedvd3dgs_tpu_torch.scene.ply import load_gaussian_ply
from guidedvd3dgs_tpu_torch.utils.general import build_rotation, inverse_sigmoid
from guidedvd3dgs_tpu_torch.utils.sh import RGB2SH

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


class GaussianParams(nn.Module):
    """xyz (N, 3), features_dc (N, 1, 3), features_rest (N, R, 3), scaling
    (N, 3) log-scale, rotation (N, 4) unnormalized quaternion (w, x, y, z),
    opacity (N, 1) logit."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation, opacity):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        n = torch.linalg.norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(n, min=1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)  # (N, 1 + R, 3)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The six parameters by name (detached)."""
        return {k: getattr(self, k).detach() for k in PARAM_NAMES}

    def set_tensors(self, values: Dict[str, torch.Tensor]) -> None:
        """Replace every parameter (new row counts allowed)."""
        for k in PARAM_NAMES:
            setattr(self, k, nn.Parameter(values[k].contiguous()))

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "GaussianParams":
        """From numpy arrays under the names of `scene/ply.py::
        load_gaussian_ply` (xyz, features_dc, features_rest, scaling,
        rotation, opacity)."""
        t = {
            k: torch.from_numpy(np.ascontiguousarray(arrays[k], dtype=np.float32)).to(device)
            for k in PARAM_NAMES
        }
        return cls(**t)

    @classmethod
    def from_ply(cls, path: str, device) -> "GaussianParams":
        """Load a `point_cloud.ply` snapshot: exactly its N rows."""
        return cls.from_arrays(load_gaussian_ply(path), device)


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    adam_m: Dict[str, torch.Tensor]
    adam_v: Dict[str, torch.Tensor]
    step: int  # shared Adam step
    confidence: torch.Tensor  # (N, 1)
    max_radii2d: torch.Tensor  # (N,)
    xyz_gradient_accum: torch.Tensor  # (N, 1)
    denom: torch.Tensor  # (N, 1)

    @property
    def num_gaussians(self) -> int:
        return self.params.num_gaussians

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @classmethod
    def fresh(cls, params: GaussianParams) -> "GaussianState":
        """Zero moments and statistics, confidence 1."""
        n, dev = params.num_gaussians, params.xyz.device
        return cls(
            params=params,
            adam_m={k: torch.zeros_like(v) for k, v in params.tensors().items()},
            adam_v={k: torch.zeros_like(v) for k, v in params.tensors().items()},
            step=0,
            confidence=torch.ones((n, 1), device=dev),
            max_radii2d=torch.zeros((n,), device=dev),
            xyz_gradient_accum=torch.zeros((n, 1), device=dev),
            denom=torch.zeros((n, 1), device=dev),
        )


class LearningRates(NamedTuple):
    xyz: float  # scheduled per step
    f_dc: float
    f_rest: float
    opacity: float
    scaling: float
    rotation: float

    def of(self, name: str) -> float:
        return {"xyz": self.xyz, "features_dc": self.f_dc, "features_rest": self.f_rest,
                "scaling": self.scaling, "rotation": self.rotation, "opacity": self.opacity}[name]


class DensifyConfig(NamedTuple):
    grad_threshold: float
    min_opacity: float
    extent: float
    max_screen_size: float  # 0 => disabled
    percent_dense: float
    dist_thres: float
    prune_enabled: bool  # iteration > prune_from_iter
    proximity_enabled: bool  # iteration < 2000


def create_from_pcd(points: np.ndarray, colors: np.ndarray, max_sh_degree: int = 3,
                    use_color: bool = True, device="cpu") -> GaussianState:
    """Initialize from a point cloud: SH DC from RGB, log-scale = log sqrt of
    the mean squared 3-NN distance, opacity 0.1, identity rotation."""
    xyz = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    n = xyz.shape[0]
    rest = (max_sh_degree + 1) ** 2 - 1
    fdc = torch.zeros((n, 1, 3), device=device)
    if use_color:
        fdc[:, 0] = torch.from_numpy(RGB2SH(np.asarray(colors, np.float32))).to(device)
    rot = torch.zeros((n, 4), device=device)
    rot[:, 0] = 1.0
    op = inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32))
    d2, _ = dist_knn3(xyz)
    scales = 0.5 * torch.log(torch.clamp(d2, min=1e-7))  # log sqrt(d2)
    params = GaussianParams(
        xyz=xyz,
        features_dc=fdc,
        features_rest=torch.zeros((n, rest, 3), device=device),
        scaling=scales[:, None].repeat(1, 3),
        rotation=rot,
        opacity=torch.full((n, 1), float(op), device=device),
    )
    return GaussianState.fresh(params)


@torch.no_grad()
def adam_step(state: GaussianState, grads: Dict[str, torch.Tensor], lrs: LearningRates) -> GaussianState:
    """One Adam step over every row: m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, p -= lr (m / bc1) / (sqrt(v / bc2) + eps) with
    the bias corrections of the shared step. Rows with a zero gradient still
    decay their moments, as torch's Adam does."""
    state.step += 1
    t = np.float32(state.step)
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
    # one multi-tensor launch per operation over the six parameters
    ps = [getattr(state.params, n) for n in PARAM_NAMES]
    gs = [grads[n] for n in PARAM_NAMES]
    ms = [state.adam_m[n] for n in PARAM_NAMES]
    vs = [state.adam_v[n] for n in PARAM_NAMES]
    torch._foreach_mul_(ms, ADAM_B1)
    torch._foreach_add_(ms, gs, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(vs, ADAM_B2)
    torch._foreach_addcmul_(vs, gs, gs, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_addcdiv_(ps, ms, denom, [-lrs.of(n) / bc1 for n in PARAM_NAMES])
    return state


@torch.no_grad()
def add_densification_stats(state: GaussianState, viewspace_grad: torch.Tensor,
                            update_filter: torch.Tensor) -> GaussianState:
    gnorm = torch.linalg.norm(viewspace_grad[:, :2], dim=-1, keepdim=True)
    f = update_filter[:, None]
    state.xyz_gradient_accum += torch.where(f, gnorm, torch.zeros_like(gnorm))
    state.denom += f.to(state.denom.dtype)
    return state


@torch.no_grad()
def add_densification_stats_with_novel_pose(
    state: GaussianState, viewspace_grad: torch.Tensor, update_filter: torch.Tensor,
    viewspace_grad_novel: torch.Tensor, update_filter_novel: torch.Tensor,
    novel_pose_scale: float = 1.0,
) -> GaussianState:
    """The train and pseudo views' statistics in one: the norm of the sum of
    their viewspace gradients, counted where either view sees the Gaussian
    (reference gaussian_model.py:530-544)."""
    g = viewspace_grad + viewspace_grad_novel / novel_pose_scale
    return add_densification_stats(state, g, update_filter | update_filter_novel)


@torch.no_grad()
def update_max_radii(state: GaussianState, radii: torch.Tensor,
                     visibility: torch.Tensor) -> GaussianState:
    state.max_radii2d = torch.where(
        visibility, torch.maximum(state.max_radii2d, radii.to(torch.float32)), state.max_radii2d
    )
    return state


def _append_rows(state: GaussianState, new: Dict[str, torch.Tensor], sel: torch.Tensor) -> None:
    """Append the `sel` rows of `new` (row-aligned with `sel`) at the end,
    in index order: zero Adam moments and statistics, confidence 1."""
    k = int(sel.sum())
    if k == 0:
        return
    cur = state.params.tensors()
    rows = {n: new[n][sel] for n in PARAM_NAMES}
    state.params.set_tensors({n: torch.cat([cur[n], rows[n]]) for n in PARAM_NAMES})
    for mom in (state.adam_m, state.adam_v):
        for n in PARAM_NAMES:
            mom[n] = torch.cat([mom[n], torch.zeros_like(rows[n])])
    dev = state.device
    state.confidence = torch.cat([state.confidence, torch.ones((k, 1), device=dev)])
    state.max_radii2d = torch.cat([state.max_radii2d, torch.zeros((k,), device=dev)])
    state.xyz_gradient_accum = torch.cat([state.xyz_gradient_accum, torch.zeros((k, 1), device=dev)])
    state.denom = torch.cat([state.denom, torch.zeros((k, 1), device=dev)])


def _remove_rows(state: GaussianState, mask: torch.Tensor) -> None:
    """Drop the `mask` rows, keeping the order of the others."""
    keep = ~mask
    if bool(keep.all()):
        return
    state.params.set_tensors({n: t[keep] for n, t in state.params.tensors().items()})
    for mom in (state.adam_m, state.adam_v):
        for n in PARAM_NAMES:
            mom[n] = mom[n][keep]
    state.confidence = state.confidence[keep]
    state.max_radii2d = state.max_radii2d[keep]
    state.xyz_gradient_accum = state.xyz_gradient_accum[keep]
    state.denom = state.denom[keep]


@torch.no_grad()
def densify_and_clone(state: GaussianState, grads: torch.Tensor, cfg: DensifyConfig) -> GaussianState:
    """Copy the small Gaussians whose mean viewspace gradient reaches the
    threshold."""
    p = state.params
    sel = (grads[:, 0] >= cfg.grad_threshold) & (
        p.get_scaling.max(dim=-1).values <= cfg.percent_dense * cfg.extent
    )
    _append_rows(state, p.tensors(), sel)
    return state


@torch.no_grad()
def densify_and_split(state: GaussianState, grads: torch.Tensor, cfg: DensifyConfig,
                      n_split: int = 2, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> GaussianState:
    """Replace each large Gaussian whose mean viewspace gradient reaches the
    threshold (or that is large and isolated) by `n_split` smaller ones
    sampled inside it. `noise` (n_split, >= N, 3) standard normal rows (the
    first N are used), or drawn from `generator`: child i of row r sits at
    xyz + R (noise[i, r] * s)."""
    p = state.params
    n = p.num_gaussians
    scal = p.get_scaling
    max_scale = scal.max(dim=-1).values
    sel = (grads[:, 0] >= cfg.grad_threshold) & (max_scale > cfg.percent_dense * cfg.extent)
    d2, _ = dist_knn3(p.xyz.detach())
    sel = sel | ((d2 > cfg.dist_thres * cfg.extent) & (max_scale > cfg.extent))

    rot_mats = build_rotation(p.get_rotation)
    new_scaling = torch.log(scal / (0.8 * n_split))
    src = p.tensors()
    for i in range(n_split):
        if noise is None:
            z = torch.randn((n, 3), generator=generator, device=state.device)
        else:
            z = noise[i, :n].to(state.device)
        offset = torch.einsum("nij,nj->ni", rot_mats, z * scal)
        _append_rows(state, dict(src, xyz=src["xyz"] + offset, scaling=new_scaling), sel)
    if cfg.prune_enabled:
        tail = torch.zeros(state.num_gaussians - n, dtype=torch.bool, device=state.device)
        _remove_rows(state, torch.cat([sel, tail]))
    return state


@torch.no_grad()
def proximity(state: GaussianState, cfg: DensifyConfig) -> GaussianState:
    """Insert midpoints toward the 3 nearest neighbours of isolated large
    Gaussians (each selected point with its own 3 neighbours)."""
    p = state.params
    d2, nn_idx = dist_knn3(p.xyz.detach())
    sel = (d2 > 5.0 * cfg.extent) & (p.get_scaling.max(dim=-1).values > cfg.extent)
    src = p.tensors()
    identity = torch.zeros_like(src["rotation"])
    identity[:, 0] = 1.0
    for k in range(3):
        nk = nn_idx[:, k]
        new = dict(
            xyz=(src["xyz"] + src["xyz"][nk]) / 2.0,
            features_dc=torch.zeros_like(src["features_dc"]),
            features_rest=torch.zeros_like(src["features_rest"]),
            scaling=src["scaling"][nk],
            rotation=identity,
            opacity=src["opacity"][nk],
        )
        _append_rows(state, new, sel)
    return state


@torch.no_grad()
def densify_and_prune(state: GaussianState, cfg: DensifyConfig, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> GaussianState:
    """The densification event: clone, split (removing the split sources
    when pruning is on), proximity (before iteration 2000), then the
    opacity / size prune; every statistic is zeroed."""
    grads = state.xyz_gradient_accum / torch.clamp(state.denom, min=1e-12)
    grads = torch.nan_to_num(torch.where(state.denom > 0, grads, torch.zeros_like(grads)))
    n0 = state.num_gaussians
    densify_and_clone(state, grads, cfg)
    # fresh clones have zero gradient
    grads = torch.cat([grads, torch.zeros((state.num_gaussians - n0, 1), device=state.device)])
    densify_and_split(state, grads, cfg, noise=noise, generator=generator)
    if cfg.proximity_enabled:
        proximity(state, cfg)
    p = state.params
    prune = p.get_opacity[:, 0] < cfg.min_opacity
    if cfg.max_screen_size > 0:
        big_vs = state.max_radii2d > cfg.max_screen_size
        big_ws = p.get_scaling.max(dim=-1).values > 0.1 * cfg.extent
        prune = prune | big_vs | big_ws
    if cfg.prune_enabled:
        _remove_rows(state, prune)
    state.xyz_gradient_accum.zero_()
    state.denom.zero_()
    state.max_radii2d.zero_()
    return state


@torch.no_grad()
def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp the opacity to <= 0.05 and zero its Adam moments."""
    p = state.params
    p.opacity.copy_(inverse_sigmoid(torch.clamp(p.get_opacity, max=0.05)))
    state.adam_m["opacity"].zero_()
    state.adam_v["opacity"].zero_()
    return state


@torch.no_grad()
def add_points(state: GaussianState, new_pts: np.ndarray, new_rgbs: np.ndarray) -> GaussianState:
    """Append lifted points (reference gaussian_model.py:547-567, JAX
    models/gaussians.py::add_points): features_dc the colour as given,
    features_rest zero, log-scale log sqrt of the mean squared distance to
    the new points' 3 nearest among themselves, the identity quaternion
    (the reference's zero quaternion, which its rasterizer treats as the
    identity), opacity 0.1; zero Adam moments for the new rows, and the
    densification statistics of every row zeroed."""
    dev = state.device
    pts = torch.from_numpy(np.ascontiguousarray(new_pts, np.float32)).to(dev)
    n = pts.shape[0]
    if n == 0:
        return state
    d2, _ = dist_knn3(pts)
    rot = torch.zeros((n, 4), device=dev)
    rot[:, 0] = 1.0
    new = dict(
        xyz=pts,
        features_dc=torch.from_numpy(np.ascontiguousarray(new_rgbs, np.float32)).to(dev)[:, None, :],
        features_rest=torch.zeros((n,) + tuple(state.params.features_rest.shape[1:]), device=dev),
        scaling=(0.5 * torch.log(torch.clamp(d2, min=1e-7)))[:, None].repeat(1, 3),
        rotation=rot,
        opacity=torch.full((n, 1), float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32))), device=dev),
    )
    _append_rows(state, new, torch.ones(n, dtype=torch.bool, device=dev))
    state.xyz_gradient_accum.zero_()
    state.denom.zero_()
    state.max_radii2d.zero_()
    return state
