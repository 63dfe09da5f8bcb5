"""Kernel K1: the fused preprocess forward and its plain version.

Counterpart of `guidedvd3dgs_tpu/ops/preprocess_pallas.py::
preprocess_fused_fwd`. Both return the (16, N) f32 table:
  rows 0-9   render fields in F_* order (below)
             (mx, my, conic a, b, c, opacity, r, g, b, depth)
  row 10     radius (3-sigma, before the visibility mask)
  row 11     visible (1.0 / 0.0: in front of the near plane, invertible)
  rows 12-13 ext_x, ext_y (tight binning extents)
  rows 14-15 zero
The CUDA kernel is csrc/preprocess_fwd.cu; the plain version is
ops/projection.py::preprocess_field_rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera, preprocess_field_rows

NUM_ROWS = 16
# row layout of the table, shared by the binning and the blend
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_D = range(10)
ROW_RADIUS, ROW_VISIBLE, ROW_EXT_X, ROW_EXT_Y = 10, 11, 12, 13


def cam_consts(cam: RasterCamera) -> torch.Tensor:
    """(39,) f32 camera row on the camera's device: V (16, row-major),
    P (16), campos (3), focal_x, focal_y, limx, limy. The focal
    lengths and FOV limits are computed in double on the host, as the
    plain version does, and rounded once."""
    scal = torch.tensor(
        [
            cam.width / (2.0 * cam.tanfovx),
            cam.height / (2.0 * cam.tanfovy),
            1.3 * cam.tanfovx,
            1.3 * cam.tanfovy,
        ],
        dtype=torch.float32,
    ).to(cam.device, non_blocking=True)
    return torch.cat(
        [
            cam.viewmatrix.reshape(-1).float(),
            cam.projmatrix.reshape(-1).float(),
            cam.campos.reshape(-1).float(),
            scal,
        ]
    ).contiguous()


def visible_radii(tab: torch.Tensor) -> torch.Tensor:
    """(N,) int32 radius of each Gaussian, 0 where row 11 culls it."""
    visible = tab[ROW_VISIBLE] > 0.5
    return torch.where(visible, tab[ROW_RADIUS], torch.zeros_like(tab[0])).to(torch.int32)


def preprocess_table_plain(
    means3d, scales, rotations, opacities, shs, cam: RasterCamera,
    sh_degree: int, scale_modifier: float, active_degree: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    fields10, radius, visible, ext_x, ext_y = preprocess_field_rows(
        means3d, scales, rotations, opacities, shs, cam, sh_degree, scale_modifier,
        active_degree=active_degree,
    )
    zeros = torch.zeros_like(radius)
    return torch.stack(
        list(fields10) + [radius, visible.to(radius.dtype), ext_x, ext_y, zeros, zeros]
    )


def preprocess_fused_fwd(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: RasterCamera,
    sh_degree: int,
    scale_modifier: float,
    active_degree: Optional[int] = None,
) -> torch.Tensor:
    """(16, N) preprocess table. Inputs post-activation: means/scales
    (N, 3), rotations (N, 4), opacities (N,) or (N, 1), shs (N, K, 3) with
    K >= (sh_degree + 1)**2. CPU tensors take the plain version; CUDA
    tensors launch kernel K1."""
    if means3d.device.type == "cpu":
        return preprocess_table_plain(
            means3d, scales, rotations, opacities, shs, cam, sh_degree,
            scale_modifier, active_degree,
        )
    if means3d.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {means3d.device}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"sh_degree {sh_degree} not in [0, 3]")
    dev = means3d.device
    n = means3d.shape[0]
    _build.check_cuda("means3d", means3d, torch.float32, dev, (n, 3))
    _build.check_cuda("scales", scales, torch.float32, dev, (n, 3))
    _build.check_cuda("rotations", rotations, torch.float32, dev, (n, 4))
    _build.check_cuda("opacities", opacities, torch.float32, dev)
    if opacities.numel() != n:
        raise ValueError(f"opacities has {opacities.numel()} values for {n} Gaussians")
    _build.check_cuda("shs", shs, torch.float32, dev, (n, None, 3))
    if shs.shape[1] < (sh_degree + 1) ** 2:
        raise ValueError(f"shs has {shs.shape[1]} coefficients, degree {sh_degree} needs more")
    if cam.device != dev:
        raise ValueError(f"camera on {cam.device}, Gaussians on {dev}")
    camc = cam_consts(cam)
    out = torch.empty((NUM_ROWS, n), dtype=torch.float32, device=dev)
    act = sh_degree if active_degree is None else int(active_degree)
    _build.launch(
        "preprocess_fwd",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(),
        shs.data_ptr(), camc.data_ptr(), out.data_ptr(),
        n, shs.shape[1], sh_degree, act, float(scale_modifier), cam.width, cam.height,
        _build.stream_of(out),
    )
    return out
