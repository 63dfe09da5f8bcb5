"""The plain reference's training step of the 3D Gaussian scene: the
3DGS original's per-iteration semantics as the port states them
(train/baseline.py and models/gaussians.py, frozen here):

  * loss = (1 - lambda) L1 + lambda (1 - SSIM), 11 x 11 Gaussian window;
  * the gradient of every parameter by autograd through raster.py;
  * densification statistics: the norm of the screen-offset gradient's
    x, y added where a view sees the Gaussian, the view count, the
    largest screen radius;
  * Adam with eps 1e-15, one shared step and the bias corrections of that
    step in float32, rows with a zero gradient decaying their moments; no
    Adam step on a densification iteration;
  * densify and prune: clone small Gaussians whose mean screen gradient
    reaches the threshold, split large ones (two children drawn from a
    generator seeded with the iteration, sources removed), then prune by
    opacity; every statistic zeroed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@dataclass
class State:
    p: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int
    accum: torch.Tensor  # (N, 1) summed screen-gradient norms
    denom: torch.Tensor  # (N, 1) views that saw each Gaussian
    max_radii: torch.Tensor  # (N,)

    @classmethod
    def fresh(cls, p: Dict[str, torch.Tensor]) -> "State":
        n, dev = p["xyz"].shape[0], p["xyz"].device
        return cls({k: p[k].clone() for k in PARAM_NAMES}, {k: torch.zeros_like(p[k]) for k in PARAM_NAMES},
                   {k: torch.zeros_like(p[k]) for k in PARAM_NAMES}, 0, torch.zeros((n, 1), device=dev),
                   torch.zeros((n, 1), device=dev), torch.zeros((n,), device=dev))

    @property
    def n(self) -> int:
        return self.p["xyz"].shape[0]


def _ssim_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([np.exp(-((x - size // 2) ** 2) / (2 * sigma ** 2)) for x in range(size)])
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images."""
    a, b = a[None], b[None]
    c = a.shape[1]
    win = torch.from_numpy(_ssim_window(size)).to(a.device, a.dtype).expand(c, 1, size, size).contiguous()

    def blur(x):
        return F.conv2d(x, win, padding=size // 2, groups=c)

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def image_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    return (1.0 - lambda_dssim) * torch.abs(img - gt).mean() + lambda_dssim * (1.0 - ssim(img, gt))


def with_grad(state: State) -> Dict[str, torch.Tensor]:
    return {k: state.p[k].detach().requires_grad_() for k in PARAM_NAMES}


def params_tuple(p: Dict[str, torch.Tensor]):
    return tuple(p[k] for k in PARAM_NAMES)


@torch.no_grad()
def add_stats(state: State, offset_grad: torch.Tensor, visible: torch.Tensor, radii: torch.Tensor) -> None:
    state.max_radii = torch.where(visible, torch.maximum(state.max_radii, radii.float()), state.max_radii)
    g = torch.linalg.norm(offset_grad[:, :2], dim=-1, keepdim=True)
    f = visible[:, None]
    state.accum += torch.where(f, g, torch.zeros_like(g))
    state.denom += f.float()


@torch.no_grad()
def adam(state: State, grads: Dict[str, torch.Tensor], lrs: Dict[str, float]) -> None:
    state.step += 1
    t = np.float32(state.step)
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
    for k in PARAM_NAMES:
        g = grads[k]
        state.m[k] = ADAM_B1 * state.m[k] + (1.0 - ADAM_B1) * g
        state.v[k] = ADAM_B2 * state.v[k] + (1.0 - ADAM_B2) * g * g
        state.p[k] = state.p[k] - lrs[k] / bc1 * state.m[k] / (torch.sqrt(state.v[k] / bc2) + ADAM_EPS)


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
                        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
                        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
                       dim=-1).reshape(*q.shape[:-1], 3, 3)


def knn3_sq(x: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest other points, exact."""
    out = []
    for i in range(0, x.shape[0], chunk):
        d = torch.cdist(x[i:i + chunk], x).square()
        d[torch.arange(d.shape[0]), torch.arange(i, i + d.shape[0])] = float("inf")
        out.append(d.topk(3, largest=False).values.mean(-1))
    return torch.clamp(torch.cat(out), min=1e-7)


def _append(state: State, new: Dict[str, torch.Tensor], sel: torch.Tensor) -> None:
    k = int(sel.sum())
    if k == 0:
        return
    dev = state.p["xyz"].device
    for name in PARAM_NAMES:
        rows = new[name][sel]
        state.p[name] = torch.cat([state.p[name], rows])
        state.m[name] = torch.cat([state.m[name], torch.zeros_like(rows)])
        state.v[name] = torch.cat([state.v[name], torch.zeros_like(rows)])
    state.accum = torch.cat([state.accum, torch.zeros((k, 1), device=dev)])
    state.denom = torch.cat([state.denom, torch.zeros((k, 1), device=dev)])
    state.max_radii = torch.cat([state.max_radii, torch.zeros((k,), device=dev)])


def _remove(state: State, mask: torch.Tensor) -> None:
    keep = ~mask
    for d in (state.p, state.m, state.v):
        for name in PARAM_NAMES:
            d[name] = d[name][keep]
    state.accum, state.denom, state.max_radii = state.accum[keep], state.denom[keep], state.max_radii[keep]


@dataclass
class DensifyCfg:
    grad_threshold: float
    min_opacity: float
    extent: float
    percent_dense: float
    dist_thres: float
    prune_enabled: bool


@torch.no_grad()
def densify_and_prune(state: State, cfg: DensifyCfg, iteration: int, n_split: int = 2) -> None:
    grads = state.accum / torch.clamp(state.denom, min=1e-12)
    grads = torch.nan_to_num(torch.where(state.denom > 0, grads, torch.zeros_like(grads)))
    n0 = state.n
    scal = torch.exp(state.p["scaling"])
    sel = (grads[:, 0] >= cfg.grad_threshold) & (scal.max(-1).values <= cfg.percent_dense * cfg.extent)
    _append(state, {k: v.clone() for k, v in state.p.items()}, sel)
    grads = torch.cat([grads, torch.zeros((state.n - n0, 1), device=grads.device)])
    # split
    n = state.n
    scal = torch.exp(state.p["scaling"])
    max_scale = scal.max(-1).values
    sel = (grads[:, 0] >= cfg.grad_threshold) & (max_scale > cfg.percent_dense * cfg.extent)
    large = max_scale > cfg.extent
    if bool(large.any()):  # the isolation rule needs the neighbours only where a Gaussian is large
        sel = sel | ((knn3_sq(state.p["xyz"]) > cfg.dist_thres * cfg.extent) & large)
    q = state.p["rotation"]
    rot = build_rotation(q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12))
    new_scaling = torch.log(scal / (0.8 * n_split))
    src = {k: v.clone() for k, v in state.p.items()}
    gen = torch.Generator(device=state.p["xyz"].device)
    gen.manual_seed(iteration)
    for _ in range(n_split):
        z = torch.randn((n, 3), generator=gen, device=state.p["xyz"].device)
        off = torch.einsum("nij,nj->ni", rot, z * scal)
        _append(state, dict(src, xyz=src["xyz"] + off, scaling=new_scaling), sel)
    if cfg.prune_enabled:
        tail = torch.zeros(state.n - n, dtype=torch.bool, device=sel.device)
        _remove(state, torch.cat([sel, tail]))
    prune = torch.sigmoid(state.p["opacity"])[:, 0] < cfg.min_opacity
    if cfg.prune_enabled:
        _remove(state, prune)
    state.accum.zero_()
    state.denom.zero_()
    state.max_radii.zero_()
