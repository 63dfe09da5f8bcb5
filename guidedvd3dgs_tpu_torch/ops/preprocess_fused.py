"""Kernels K1 and K2: the fused preprocess forward and its VJP, with their
plain versions.

Counterpart of `guidedvd3dgs_tpu/ops/preprocess_pallas.py::
preprocess_fused_fwd` and `preprocess_fused_bwd`. The forward returns the
(16, N) f32 table:
  rows 0-9   render fields in F_* order (below)
             (mx, my, conic a, b, c, opacity, r, g, b, depth)
  row 10     radius (3-sigma, before the visibility mask)
  row 11     visible (1.0 / 0.0: in front of the near plane, invertible)
  rows 12-13 ext_x, ext_y (tight binning extents)
  rows 14-15 zero
The CUDA kernel is csrc/preprocess_fwd.cu; the plain version is
ops/projection.py::preprocess_field_rows. The backward maps the (10, N)
cotangents of rows 0-9 to the gradients of the five inputs; its kernel is
csrc/preprocess_bwd.cu (it recomputes the forward and keeps no
residuals), its plain version torch.autograd through the same
preprocess_field_rows.

The SH (`shs`) is one (N, K, 3) tensor or the model's pair
(features_dc (N, 1, 3), features_rest (N, K - 1, 3)). The kernels read
either in place (band 0 and the rest as two row sources, each a pointer
and a row stride) and K2 writes the SH gradient in the form it was given;
the plain versions concatenate the pair.

The tile rasterizer asks K1 for two things the JAX kernel leaves to its
caller: the screen offset of densification added to rows 0-1
(`means2d_offset`), and, with `skip_unbinned`, rows 6-8 (the colour) only
for the Gaussians that ops/tiling.py::tile_rects gives a tile, 0 for the
others, whose SH is then not read (no later kernel reads their colour).

A chain of B cameras (ops/raster_tiles.py) keeps one (16, B N) table: K1
runs once a camera and writes its columns [c N, (c + 1) N) in place
(`out`, `col0`), each camera's means its own; K2 runs once a camera on its
columns of the (10, B N) cotangents (a strided view) and, from the second
camera on, adds its gradients to the first's (`accumulate`), in camera
order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera, preprocess_field_rows

# (N, K, 3), or (features_dc (N, 1, 3), features_rest (N, K - 1, 3))
SH = Union[torch.Tensor, Sequence[torch.Tensor]]

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


def concat_sh(shs: SH) -> torch.Tensor:
    """The SH as one (N, K, 3) tensor."""
    return shs if isinstance(shs, torch.Tensor) else torch.cat(list(shs), dim=1)


def _sh_rows(shs: SH, dev: torch.device, n: int, need: int):
    """K1's and K2's SH arguments: (pointer, row stride) of band 0 and of
    bands 1.., and K. A (N, K, 3) tensor is its own two sources (band 0 at
    shs, the rest 3 floats on, both rows of 3K); each source must be f32
    on `dev` with contiguous 3-float coefficients."""
    if isinstance(shs, torch.Tensor):
        parts = (shs[:, :1], shs[:, 1:])
        _build.check_cuda("shs", shs, torch.float32, dev, (n, None, 3))
    else:
        parts = tuple(shs)
    k_total = parts[0].shape[1] + parts[1].shape[1]
    if k_total < need:
        raise ValueError(f"SH has {k_total} coefficients, {need} needed")
    args = []
    for name, t, k in zip(("features_dc", "features_rest"), parts, (1, k_total - 1)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got {t.dtype} on {t.device}")
        if t.dim() != 3 or tuple(t.shape) != (n, k, 3):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, k, 3)}")
        if k and (t.stride(2) != 1 or (k > 1 and t.stride(1) != 3) or t.stride(0) < 3 * k):
            raise ValueError(f"{name} needs rows of contiguous coefficients, strides {t.stride()}")
        args += [t.data_ptr(), t.stride(0) if k else 0]
    return args, k_total


def preprocess_table_plain(
    means3d, scales, rotations, opacities, shs: SH, cam: RasterCamera,
    sh_degree: int, scale_modifier: float, active_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None, skip_unbinned: bool = False,
    out: Optional[torch.Tensor] = None, col0: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (`preprocess_fused_fwd`'s arguments)."""
    fields10, radius, visible, ext_x, ext_y = preprocess_field_rows(
        means3d, scales, rotations, opacities, concat_sh(shs), cam, sh_degree, scale_modifier,
        active_degree=active_degree,
    )
    zeros = torch.zeros_like(radius)
    tab = torch.stack(
        list(fields10) + [radius, visible.to(radius.dtype), ext_x, ext_y, zeros, zeros]
    )
    if means2d_offset is not None:
        # the screen-space hook of densification: means2d + offset * (W/2, H/2)
        tab[F_MX] = tab[F_MX] + means2d_offset[:, 0] * (0.5 * cam.width)
        tab[F_MY] = tab[F_MY] + means2d_offset[:, 1] * (0.5 * cam.height)
    if skip_unbinned:
        from guidedvd3dgs_tpu_torch.ops.tiling import tile_rects  # tiling imports this module

        count = tile_rects(tab[F_MX], tab[F_MY], visible_radii(tab), tab[ROW_EXT_X],
                           tab[ROW_EXT_Y], cam.width, cam.height)[4]
        tab[F_R:F_D, count == 0] = 0.0
    if out is None:
        return tab
    out[:, col0:col0 + tab.shape[1]] = tab
    return out


def preprocess_fused_fwd(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: SH,
    cam: RasterCamera,
    sh_degree: int,
    scale_modifier: float,
    active_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    skip_unbinned: bool = False,
    out: Optional[torch.Tensor] = None,
    col0: int = 0,
) -> torch.Tensor:
    """(16, N) preprocess table. Inputs post-activation: means/scales
    (N, 3), rotations (N, 4), opacities (N,) or (N, 1), SH (N, K, 3) or
    its (features_dc, features_rest) pair with K >= (sh_degree + 1)**2;
    `means2d_offset` (N, 2) is added to rows 0-1 times (W/2, H/2); with
    `skip_unbinned`, rows 6-8 are 0 for the Gaussians without a tile.
    With `out`, a contiguous (16, L) table, the rows go to its columns
    [col0, col0 + N) and `out` is returned. CPU tensors take the plain
    version; CUDA tensors launch kernel K1."""
    n = means3d.shape[0]
    if out is not None and (out.dim() != 2 or out.shape[0] != NUM_ROWS or not out.is_contiguous()
                            or not 0 <= col0 <= out.shape[1] - n):
        raise ValueError(f"out {tuple(out.shape)} has no contiguous columns [{col0}, {col0 + n})")
    if means3d.device.type == "cpu":
        return preprocess_table_plain(
            means3d, scales, rotations, opacities, shs, cam, sh_degree,
            scale_modifier, active_degree, means2d_offset, skip_unbinned, out, col0,
        )
    if means3d.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {means3d.device}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"sh_degree {sh_degree} not in [0, 3]")
    dev = means3d.device
    _build.check_cuda("means3d", means3d, torch.float32, dev, (n, 3))
    _build.check_cuda("scales", scales, torch.float32, dev, (n, 3))
    _build.check_cuda("rotations", rotations, torch.float32, dev, (n, 4))
    _build.check_cuda("opacities", opacities, torch.float32, dev)
    if opacities.numel() != n:
        raise ValueError(f"opacities has {opacities.numel()} values for {n} Gaussians")
    sh_args, _ = _sh_rows(shs, dev, n, (sh_degree + 1) ** 2)
    if means2d_offset is not None:
        _build.check_cuda("means2d_offset", means2d_offset, torch.float32, dev, (n, 2))
    if cam.device != dev:
        raise ValueError(f"camera on {cam.device}, Gaussians on {dev}")
    camc = cam_consts(cam)
    if out is None:
        out = torch.empty((NUM_ROWS, n), dtype=torch.float32, device=dev)
    else:
        _build.check_cuda("out", out, torch.float32, dev, (NUM_ROWS, None))
    act = sh_degree if active_degree is None else int(active_degree)
    _build.launch(
        "preprocess_fwd",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(),
        *sh_args, camc.data_ptr(),
        None if means2d_offset is None else means2d_offset.data_ptr(),
        out.data_ptr() + 4 * col0, n, sh_degree, act, float(scale_modifier), cam.width, cam.height,
        int(skip_unbinned), out.shape[1], _build.stream_of(out),
    )
    return out


def preprocess_fused_bwd_plain(
    means3d, scales, rotations, opacities, shs: SH, cam: RasterCamera,
    sh_degree: int, scale_modifier: float, cot10: torch.Tensor,
    active_degree: Optional[int] = None, accumulate=None,
):
    """Plain PyTorch version of K2 (`preprocess_fused_bwd`'s arguments):
    torch.autograd.grad of the ten field rows of preprocess_field_rows
    against the cotangent rows. The SH gradient comes in the form the SH
    was given (a tensor or a pair)."""
    pair = not isinstance(shs, torch.Tensor)
    sh_in = list(shs) if pair else [shs]
    prims = [t.detach().requires_grad_(True) for t in [means3d, scales, rotations, opacities] + sh_in]
    with torch.enable_grad():
        fields10, *_ = preprocess_field_rows(
            *prims[:4], concat_sh(prims[4:] if pair else prims[4]), cam, sh_degree, scale_modifier,
            active_degree=active_degree,
        )
        grads = torch.autograd.grad(fields10, prims, grad_outputs=tuple(cot10[:10]))
    grads = grads[:4] + ((tuple(grads[4:]),) if pair else grads[4:])
    if accumulate is None:
        return grads
    for old, new in zip(_flat_grads(accumulate), _flat_grads(grads)):
        old.add_(new)
    return accumulate


def preprocess_fused_bwd(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: SH,
    cam: RasterCamera,
    sh_degree: int,
    scale_modifier: float,
    cot10: torch.Tensor,
    active_degree: Optional[int] = None,
    accumulate=None,
):
    """VJP of the preprocess: cot10 is the (>= 10, N) cotangent of table
    rows 0-9 (rows past 10 are ignored; a view whose rows are contiguous,
    such as one camera's columns of a chain's sums, is read in place).
    Returns the gradients of (means3d, scales, rotations, opacities, shs),
    shaped like them (the SH's as a (features_dc, features_rest) pair where
    the SH was given so). With `accumulate`, the gradients of an earlier
    call on the same inputs, these are added to them in place (old + new)
    and returned. CPU tensors take the plain version; CUDA tensors launch
    kernel K2."""
    if means3d.device.type == "cpu":
        return preprocess_fused_bwd_plain(
            means3d, scales, rotations, opacities, shs, cam, sh_degree, scale_modifier,
            cot10, active_degree, accumulate,
        )
    if means3d.device.type != "cuda":
        raise ValueError(f"no preprocess backward kernel for device {means3d.device}")
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
    sh_args, k_total = _sh_rows(shs, dev, n, (sh_degree + 1) ** 2)
    cot = cot10[:10]
    if cot.stride(1) != 1 or cot.stride(0) < n:
        cot = cot.contiguous()
    if cot.device != dev or cot.dtype != torch.float32 or tuple(cot.shape) != (10, n):
        raise ValueError(f"cot10 must be (>= 10, {n}) float32 on {dev}, got {tuple(cot10.shape)} "
                         f"{cot10.dtype} on {cot10.device}")
    if cam.device != dev:
        raise ValueError(f"camera on {cam.device}, Gaussians on {dev}")
    camc = cam_consts(cam)
    if accumulate is None:
        g_means = torch.empty_like(means3d)
        g_scales = torch.empty_like(scales)
        g_rots = torch.empty_like(rotations)
        g_opac = torch.empty_like(opacities)
        g_dc = torch.empty((n, 1, 3), dtype=torch.float32, device=dev)
        g_rest = torch.empty((n, k_total - 1, 3), dtype=torch.float32, device=dev)
    else:
        if isinstance(shs, torch.Tensor):
            raise ValueError("accumulate takes the SH as the (features_dc, features_rest) pair")
        g_means, g_scales, g_rots, g_opac, (g_dc, g_rest) = accumulate
        for name, g, like in (("means3d", g_means, means3d), ("scales", g_scales, scales),
                              ("rotations", g_rots, rotations), ("opacities", g_opac, opacities)):
            _build.check_cuda(f"the gradient of {name}", g, torch.float32, dev, tuple(like.shape))
        _build.check_cuda("the gradient of features_dc", g_dc, torch.float32, dev, (n, 1, 3))
        _build.check_cuda("the gradient of features_rest", g_rest, torch.float32, dev, (n, k_total - 1, 3))
    act = sh_degree if active_degree is None else int(active_degree)
    _build.launch(
        "preprocess_bwd",
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), *sh_args,
        camc.data_ptr(), cot.data_ptr(), n, k_total, sh_degree, act,
        float(scale_modifier), cam.width, cam.height,
        g_means.data_ptr(), g_scales.data_ptr(), g_rots.data_ptr(), g_opac.data_ptr(),
        g_dc.data_ptr(), g_rest.data_ptr(), cot.stride(0), int(accumulate is not None),
        _build.stream_of(g_means),
    )
    g_shs = torch.cat([g_dc, g_rest], dim=1) if isinstance(shs, torch.Tensor) else (g_dc, g_rest)
    return g_means, g_scales, g_rots, g_opac, g_shs


def _flat_grads(grads):
    """The five gradients of K2 with the SH's as one or two tensors."""
    *head, g_shs = grads
    return head + ([g_shs] if isinstance(g_shs, torch.Tensor) else list(g_shs))
