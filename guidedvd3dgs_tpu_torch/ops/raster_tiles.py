"""Tile rasterizer: the production render path of the port, with its
backward.

Counterpart of `guidedvd3dgs_tpu/ops/raster_tiles.py::rasterize_tiles`
(the `_raster_core` custom VJP):
  forward   kernel K1 (ops/preprocess_fused.py)  per-Gaussian (16, N) table
            binning (ops/tiling.py)              kernel K3 + one 64-bit key sort
            kernel K4 (`_run_fwd`, csrc/blend_fwd.cu)
                                                 front-to-back alpha blend per
                                                 16x16 tile
  backward  kernel K5 (`_run_bwd`, csrc/blend_bwd.cu)
                                                 per-instance gradients of the
                                                 blend, rebuilt front to back
            kernel K6 (ops/segsum.py)            per-Gaussian sums
            kernel K2 (ops/preprocess_fused.py)  VJP of the preprocess

Blend rule (the dense oracle's), per pixel over the tile's instances:
power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped if > 0;
alpha = min(0.99, op * exp(power)), skipped if < 1/255; if
T (1 - alpha) < 1e-4 the pixel stops without adding this instance;
otherwise color, depth and 1 accumulate with weight alpha T and
T *= 1 - alpha. Output color = acc + T bg. The backward passes the 0.99
clamp through, as the reference and the CUDA original do.

Saved for the backward, as the reference keeps them: the post-activation
inputs (K2 recomputes the preprocess), the binning with K1's table (the
port's instances carry owner ids, not field copies, so the table is the
binning's field store) and the forward color, depth and alpha.

The SH reaches K1 and K2 as the model holds it, band 0 (features_dc) and
bands 1.. (features_rest) apart, and its gradient leaves K2 the same way:
no concatenation in front of K1, no split of the gradient after K2. K1
adds the screen offset to its mean rows and leaves the colour of the
Gaussians without a tile at 0 (no kernel of the chain reads it).

`rasterize_tiles_multi` renders B cameras of the same Gaussians through
one chain (JAX `rasterize_tiles_multi`, its `_raster_multi_fwd_impl` /
`_raster_multi_bwd`): K1 once a camera into the columns of one (16, B N)
table, one K3, one sort and one K4 over the B cameras' tile grids stacked
as bands (ops/tiling.py), the images (B, 3, H, W), (B, H, W), (B, H, W);
backward one K5 and one K6 over the B N rows, then K2 once a camera on its
columns of the sums, the gradients added over the cameras in camera order
(K2's accumulate mode). Each tile's instance list is the one a single
render of its camera gives, so the images and each camera's per-Gaussian
sums (and so the screen-offset gradients) are bitwise B single renders;
the parameter gradients differ from B single renders' by the order of
the sum over cameras. `rasterize_tiles` is the chain of one camera.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from guidedvd3dgs_tpu_torch.ops import _build, preprocess_fused, segsum, tiling
from guidedvd3dgs_tpu_torch.ops.projection import ALPHA_EPS, ALPHA_MAX, T_EPS, RasterCamera
from guidedvd3dgs_tpu_torch.ops.raster_dense import RenderOutput
from guidedvd3dgs_tpu_torch.ops.tiling import TILE, TileBinning

TILE_PIX = TILE * TILE
# element budget of one tile batch of the plain blend: ~10 live
# (tiles, instances, 256) f32 temporaries of this size (the backward
# keeps about twice as many and takes half the budget)
PLAIN_BATCH_ELEMS = 1 << 24


def _tiles_to_planes(tiles: torch.Tensor, gx: int, gy: int) -> torch.Tensor:
    """(num_tiles, R, TILE_PIX) -> (R, gy * TILE, gx * TILE)."""
    r = tiles.shape[1]
    x = tiles.reshape(gy, gx, r, TILE, TILE)
    return x.permute(2, 0, 3, 1, 4).reshape(r, gy * TILE, gx * TILE)


def _unband(planes: torch.Tensor, n_cams: int, height: int, width: int) -> torch.Tensor:
    """(R, n_cams * Hp, Wp) stacked bands -> (n_cams, R, height, width)."""
    r, hv, wp = planes.shape
    x = planes.reshape(r, n_cams, hv // n_cams, wp)[:, :, :height, :width]
    return x.permute(1, 0, 2, 3)


class TileBatch(NamedTuple):
    """K4's per-pixel rule in closed form over the tiles [t0, t1) of a
    binning: B tiles, K = their largest instance count, P = 256 pixels."""

    f: torch.Tensor  # (10, B, K) render fields of each tile's instances
    valid: torch.Tensor  # (B, K) instance k exists in the tile
    idx: torch.Tensor  # (B, K) its sorted instance index (clamped)
    dx: torch.Tensor  # (B, K, P) mean - pixel
    dy: torch.Tensor
    araw: torch.Tensor  # op * exp(power)
    live: torch.Tensor  # power <= 0, araw >= 1/255, valid
    alpha: torch.Tensor  # min(araw, 0.99) where live, else 0
    t_incl: torch.Tensor  # T after instance k (running product of 1 - alpha)
    t_before: torch.Tensor  # T before instance k
    trigger: torch.Tensor  # instance k would take T below 1e-4
    include: torch.Tensor  # live and before the first trigger: blended


def tile_batch(tab, binning: TileBinning, t0: int, t1: int) -> TileBatch:
    dev = tab.device
    gx, gy_cam = binning.grid_x, binning.grid_y // binning.n_cams
    cnt = binning.tile_count[t0:t1].long()
    k = max(int(cnt.max()), 1)
    ks = torch.arange(k, device=dev)
    valid = ks[None, :] < cnt[:, None]
    idx = torch.clamp(binning.tile_start[t0:t1].long()[:, None] + ks[None, :],
                      max=max(binning.num_instances - 1, 0))
    if binning.num_instances:
        f = tab[:10, binning.inst_gauss[idx].long()]
    else:
        f = torch.zeros((10,) + valid.shape, dtype=torch.float32, device=dev)
    tids = torch.arange(t0, t1, device=dev)
    lin = torch.arange(TILE_PIX, device=dev)
    pixx = ((tids % gx)[:, None] * TILE + lin[None, :] % TILE).float()  # (B, P)
    # each camera's own pixel rows: a tile row's place in its band
    pixy = (((tids // gx) % gy_cam)[:, None] * TILE + lin[None, :] // TILE).float()

    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(preprocess_fused.F_R))
    dx = mx - pixx[:, None, :]
    dy = my - pixy[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    araw = op * torch.exp(power)
    live = (power <= 0.0) & (araw >= ALPHA_EPS) & valid[:, :, None]
    alpha = torch.where(live, torch.clamp(araw, max=ALPHA_MAX), torch.zeros_like(araw))
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=1)
    t_before = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    trigger = live & (t_before * one_minus < T_EPS)
    include = live & (torch.cumsum(trigger.int(), dim=1) == 0)
    return TileBatch(f, valid, idx, dx, dy, araw, live, alpha, t_incl, t_before, trigger, include)


def _blend_tiles_plain(tab, binning: TileBinning, t0, t1, bg):
    """Plain blend of tiles [t0, t1): (t1 - t0, 5, TILE_PIX) rows color,
    depth, alpha."""
    q = tile_batch(tab, binning, t0, t1)
    w = torch.where(q.include, q.alpha * q.t_before, torch.zeros_like(q.alpha))
    # T after the last blended instance: before the stopping one, or at the end
    t_pad = torch.cat([torch.ones_like(q.t_incl[:, :1]), q.t_incl], dim=1)
    no_trigger_yet = torch.cumsum(q.trigger.int(), dim=1) == 0
    first = no_trigger_yet.sum(dim=1, keepdim=True)  # index of the stopping instance, or K
    t_final = torch.gather(t_pad, 1, first)[:, 0]  # (B, P)
    acc = torch.einsum("bkp,cbk->bcp", w, q.f[preprocess_fused.F_R:])  # (B, 4, P): r, g, b, depth
    color = acc[:, :3] + t_final[:, None, :] * bg[None, :, None]
    return torch.cat([color, acc[:, 3:4], w.sum(dim=1)[:, None]], dim=1)


def _planes_to_tiles(planes: torch.Tensor, gx: int, gy: int) -> torch.Tensor:
    """(B, R, H, W) B cameras' planes -> (gy * gx, R, TILE_PIX), each
    camera's band of gy / B tile rows zero-padded to whole tiles."""
    b, r, h, w = planes.shape
    x = torch.zeros((r, b, gy // b * TILE, gx * TILE), dtype=planes.dtype, device=planes.device)
    x[:, :, :h, :w] = planes.transpose(0, 1)
    x = x.reshape(r, gy, TILE, gx, TILE).permute(1, 3, 0, 2, 4)
    return x.reshape(gy * gx, r, TILE_PIX)


def _tile_batches(counts, budget: int):
    """Consecutive tile ranges [t0, t1) whose (tiles x max count x 256)
    stays within `budget` elements (at least one tile each)."""
    num_tiles = len(counts)
    t0 = 0
    while t0 < num_tiles:
        t1, kmax = t0 + 1, max(counts[t0], 1)
        while t1 < num_tiles and max(kmax, counts[t1]) * (t1 - t0 + 1) * TILE_PIX <= budget:
            kmax = max(kmax, counts[t1])
            t1 += 1
        yield t0, t1
        t0 = t1


def blend_fwd_plain(tab, binning: TileBinning, bg, width: int, height: int):
    """Plain PyTorch version of K4, in batches of tiles to bound memory
    (`_run_fwd`'s shapes)."""
    gx, gy = binning.grid_x, binning.grid_y
    num_tiles = gx * gy
    tiles = torch.empty((num_tiles, 5, TILE_PIX), dtype=torch.float32, device=tab.device)
    for t0, t1 in _tile_batches(binning.tile_count.tolist(), PLAIN_BATCH_ELEMS):
        tiles[t0:t1] = _blend_tiles_plain(tab, binning, t0, t1, bg)
    planes = _unband(_tiles_to_planes(tiles, gx, gy), binning.n_cams, height, width)
    return planes[:, 0:3].contiguous(), planes[:, 3].contiguous(), planes[:, 4].contiguous()


def _blend_bwd_tiles_plain(tab, binning: TileBinning, fwd, cot, t0, t1):
    """Plain backward of tiles [t0, t1). fwd, cot: (B, 5, TILE_PIX) rows
    (C (3), D, A) and (dC (3), dD, dA). Returns ((B, K, 10) instance
    gradients, (B, K) valid mask, (B, K) sorted instance index): the
    closed form of the rule, then the suffix sums from U - prefix."""
    q = tile_batch(tab, binning, t0, t1)
    w = torch.where(q.include, q.alpha * q.t_before, torch.zeros_like(q.alpha))
    dC, dD, dA = cot[:, 0:3], cot[:, 3], cot[:, 4]
    U = (fwd[:, 0:3] * dC).sum(1) + fwd[:, 3] * dD + fwd[:, 4] * dA  # (B, P)
    rgb, dep = q.f[preprocess_fused.F_R:preprocess_fused.F_D], q.f[preprocess_fused.F_D]
    u = torch.einsum("cbk,bcp->bkp", rgb, dC) + dep[:, :, None] * dD[:, None, :] + dA[:, None, :]
    prefix = torch.cumsum(w * u, dim=1)  # inclusive of instance k
    S = U[:, None, :] - prefix
    dalpha = torch.where(q.include, q.t_before * u - S / torch.clamp(1.0 - q.alpha, min=1e-3),
                         torch.zeros_like(q.alpha))
    g = dalpha * torch.where(q.live, q.araw, torch.zeros_like(q.araw))
    dx, dy = q.dx, q.dy
    s0 = g.sum(-1)
    mxs, mys = (g * dx).sum(-1), (g * dy).sum(-1)
    mxx, mxy, myy = (g * dx * dx).sum(-1), (g * dx * dy).sum(-1), (g * dy * dy).sum(-1)
    ca, cb, cc, op = (q.f[i] for i in (preprocess_fused.F_CA, preprocess_fused.F_CB,
                                        preprocess_fused.F_CC, preprocess_fused.F_OP))
    d_col = torch.einsum("bkp,bcp->bkc", w, dC)
    d_dep = (w * dD[:, None, :]).sum(-1)
    out = torch.stack(
        [-(ca * mxs + cb * mys), -(cc * mys + cb * mxs), -0.5 * mxx, -mxy, -0.5 * myy,
         s0 / torch.clamp(op, min=1e-12), d_col[..., 0], d_col[..., 1], d_col[..., 2], d_dep],
        dim=-1,
    )
    return out, q.valid, q.idx


def blend_bwd_plain(tab, binning: TileBinning, color, depth, alpha, dC, dD, dA,
                    width: int, height: int):
    """Plain PyTorch version of K5: (M, 10) per-instance gradients in
    expansion-slot order (zero for instances no pixel reached), in batches
    of tiles (`_run_bwd`'s shapes)."""
    gx, gy = binning.grid_x, binning.grid_y
    fwd = _planes_to_tiles(torch.cat([color, depth[:, None], alpha[:, None]], 1), gx, gy)
    cot = _planes_to_tiles(torch.cat([dC, dD[:, None], dA[:, None]], 1), gx, gy)
    grad = torch.zeros((binning.num_instances, segsum.NF), dtype=torch.float32, device=tab.device)
    for t0, t1 in _tile_batches(binning.tile_count.tolist(), PLAIN_BATCH_ELEMS // 2):
        out, valid, idx = _blend_bwd_tiles_plain(tab, binning, fwd[t0:t1], cot[t0:t1], t0, t1)
        grad[binning.perm[idx[valid]].long()] = out[valid]
    return grad


def _run_fwd(tab: torch.Tensor, binning: TileBinning, bg: torch.Tensor, width: int, height: int):
    """Kernel K4: blend the binned instances of the binning's B cameras
    into color (B, 3, H, W), depth (B, H, W) and alpha (B, H, W). CPU
    tensors take the plain version."""
    if tab.device.type == "cpu":
        return blend_fwd_plain(tab, binning, bg, width, height)
    if tab.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {tab.device}")
    dev = tab.device
    n = tab.shape[1]
    gx, gy = binning.grid_x, binning.grid_y
    num_tiles = gx * gy
    _build.check_cuda("tab", tab, torch.float32, dev, (16, n))
    _build.check_cuda("inst_gauss", binning.inst_gauss, torch.int32, dev, (binning.num_instances,))
    _build.check_cuda("tile_start", binning.tile_start, torch.int32, dev, (num_tiles,))
    _build.check_cuda("tile_count", binning.tile_count, torch.int32, dev, (num_tiles,))
    _build.check_cuda("tile_order", binning.tile_order, torch.int32, dev, (num_tiles,))
    _build.check_cuda("bg", bg, torch.float32, dev, (3,))
    b = binning.n_cams
    if gx != (width + TILE - 1) // TILE or gy != b * ((height + TILE - 1) // TILE):
        raise ValueError(f"binning grid {gx}x{gy} does not cover {b} images of {width}x{height}")
    color = torch.empty((b, 3, height, width), dtype=torch.float32, device=dev)
    depth = torch.empty((b, height, width), dtype=torch.float32, device=dev)
    alpha = torch.empty((b, height, width), dtype=torch.float32, device=dev)
    _build.launch(
        "blend_fwd",
        tab.data_ptr(), n, binning.inst_gauss.data_ptr(), binning.tile_start.data_ptr(),
        binning.tile_count.data_ptr(), binning.tile_order.data_ptr(), bg.data_ptr(), gx, gy,
        width, height,
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), gy // b, _build.stream_of(tab),
    )
    return color, depth, alpha


def _run_bwd(tab: torch.Tensor, binning: TileBinning, color, depth, alpha, dC, dD, dA,
             width: int, height: int) -> torch.Tensor:
    """Kernel K5: the (M, 10) per-instance gradients (F_* order: mean2D x/y,
    conic a/b/c, opacity, r/g/b, depth) at each instance's expansion slot,
    from the forward's outputs and their cotangents, shaped as `_run_fwd`
    gives the outputs. CPU tensors take the plain version."""
    if tab.device.type == "cpu":
        return blend_bwd_plain(tab, binning, color, depth, alpha, dC, dD, dA, width, height)
    if tab.device.type != "cuda":
        raise ValueError(f"no blend backward kernel for device {tab.device}")
    dev = tab.device
    n = tab.shape[1]
    m = binning.num_instances
    gx, gy = binning.grid_x, binning.grid_y
    num_tiles = gx * gy
    _build.check_cuda("tab", tab, torch.float32, dev, (16, n))
    _build.check_cuda("inst_gauss", binning.inst_gauss, torch.int32, dev, (m,))
    _build.check_cuda("perm", binning.perm, torch.int32, dev, (m,))
    _build.check_cuda("tile_start", binning.tile_start, torch.int32, dev, (num_tiles,))
    _build.check_cuda("tile_count", binning.tile_count, torch.int32, dev, (num_tiles,))
    _build.check_cuda("tile_order", binning.tile_order, torch.int32, dev, (num_tiles,))
    b = binning.n_cams
    for name, t, shape in (("color", color, (b, 3, height, width)), ("depth", depth, (b, height, width)),
                           ("alpha", alpha, (b, height, width)), ("dC", dC, (b, 3, height, width)),
                           ("dD", dD, (b, height, width)), ("dA", dA, (b, height, width))):
        _build.check_cuda(name, t, torch.float32, dev, shape)
    if gx != (width + TILE - 1) // TILE or gy != b * ((height + TILE - 1) // TILE):
        raise ValueError(f"binning grid {gx}x{gy} does not cover {b} images of {width}x{height}")
    # instances the blend never reaches (culled, or past every pixel's stop)
    # keep this zero
    grad = torch.zeros((m, segsum.NF), dtype=torch.float32, device=dev)
    _build.launch(
        "blend_bwd",
        tab.data_ptr(), n, binning.inst_gauss.data_ptr(), binning.perm.data_ptr(),
        binning.tile_start.data_ptr(), binning.tile_count.data_ptr(),
        binning.tile_order.data_ptr(),
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), dC.data_ptr(), dD.data_ptr(),
        dA.data_ptr(), gx, gy, width, height, grad.data_ptr(), gy // b, _build.stream_of(tab),
    )
    return grad


def _reduce_per_gaussian(grad_inst: torch.Tensor, binning: TileBinning) -> torch.Tensor:
    """(M, 10) per-instance gradients -> (10, N) per-Gaussian sums (kernel
    K6 over each Gaussian's contiguous expansion slots; no sort)."""
    return segsum.segment_sum_sorted(grad_inst, binning.offsets, binning.count)


class _RasterizeTiles(torch.autograd.Function):
    """B cameras: K1 x B -> binning -> K4 forward; K5 -> K6 -> K2 x B
    backward. The SH is the pair (sh_dc (N, 1, 3), sh_rest (N, K - 1, 3));
    `means2d_offset` is (B, N, 2) or None."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, sh_dc, sh_rest, means2d_offset, cfg):
        cams, bg, sh_degree, scale_modifier, active_degree = cfg
        n, b = means3d.shape[0], len(cams)
        width, height = cams[0].width, cams[0].height
        tab = torch.empty((preprocess_fused.NUM_ROWS, b * n), dtype=torch.float32,
                          device=means3d.device)
        for c, cam in enumerate(cams):
            # the screen offset (means2d + offset * (W/2, H/2)) is added by K1
            preprocess_fused.preprocess_fused_fwd(
                means3d, scales, rotations, opacities, (sh_dc, sh_rest), cam, sh_degree,
                scale_modifier, active_degree=active_degree,
                means2d_offset=None if means2d_offset is None else means2d_offset[c],
                skip_unbinned=True, out=tab, col0=c * n,
            )
        radii = preprocess_fused.visible_radii(tab)
        binning = tiling.bin_gaussians(tab, radii, width, height, n_cams=b)
        color, depth, alpha = _run_fwd(tab, binning, bg, width, height)
        ctx.save_for_backward(means3d, scales, rotations, opacities, sh_dc, sh_rest, color, depth,
                              alpha)
        ctx.tab, ctx.binning, ctx.cfg = tab, binning, cfg
        radii = radii.reshape(b, n)
        ctx.mark_non_differentiable(radii)
        return color, depth, alpha, radii, binning.num_instances

    @staticmethod
    def backward(ctx, d_color, d_depth, d_alpha, _d_radii, _d_num):
        means3d, scales, rotations, opacities, sh_dc, sh_rest, color, depth, alpha = ctx.saved_tensors
        cams, _bg, sh_degree, scale_modifier, active_degree = ctx.cfg
        n = means3d.shape[0]
        width, height = cams[0].width, cams[0].height

        def cot(g, like):
            return torch.zeros_like(like) if g is None else g.contiguous()

        grad_inst = _run_bwd(ctx.tab, ctx.binning, color, depth, alpha, cot(d_color, color),
                             cot(d_depth, depth), cot(d_alpha, alpha), width, height)
        acc = _reduce_per_gaussian(grad_inst, ctx.binning)  # (10, B N)
        grads = None
        for c, cam in enumerate(cams):
            # camera c's columns of the sums, read in place; from the second
            # camera on K2 adds to the first's gradients
            grads = preprocess_fused.preprocess_fused_bwd(
                means3d, scales, rotations, opacities, (sh_dc, sh_rest), cam, sh_degree,
                scale_modifier, acc[:, c * n:(c + 1) * n], active_degree=active_degree,
                accumulate=grads,
            )
        g_means, g_scales, g_rots, g_opac, (g_dc, g_rest) = grads
        g_off = None
        if ctx.needs_input_grad[6]:
            # the offset is additive on the mean rows: the same rows, rescaled
            rows = acc[:2].reshape(2, len(cams), n)
            g_off = torch.stack([rows[0] * (0.5 * width), rows[1] * (0.5 * height)], dim=-1)
        return g_means, g_scales, g_rots, g_opac, g_dc, g_rest, g_off, None


def _check_inputs(shs, colors_precomp, cov3d_precomp):
    if colors_precomp is not None or cov3d_precomp is not None:
        raise NotImplementedError(
            "precomputed colors / cov3D are not supported by the tile rasterizer yet"
        )
    if shs is None:
        raise ValueError("the tile rasterizer needs SH features")
    return (shs[:, :1], shs[:, 1:]) if isinstance(shs, torch.Tensor) else shs


def rasterize_tiles(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[preprocess_fused.SH],
    cam: RasterCamera,
    bg: torch.Tensor,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    active_degree: Optional[int] = None,
) -> RenderOutput:
    """Render through K1 -> binning (K3 + sort) -> K4, differentiable
    through K5 -> K6 -> K2. Inputs are post-activation; `shs` is one
    (N, K, 3) tensor or the pair (features_dc (N, 1, 3), features_rest
    (N, K - 1, 3)), which K1 and K2 read and write in place (a tensor is
    passed as its two slices); `means2d_offset` (N, 2), usually zeros that
    require grad, is added to the screen means scaled by (W/2, H/2), and
    its gradient is the viewspace gradient that densification reads. CUDA
    tensors run the kernels, CPU tensors their plain versions."""
    sh_dc, sh_rest = _check_inputs(shs, colors_precomp, cov3d_precomp)
    cfg = ((cam,), bg, sh_degree, float(scale_modifier), active_degree)
    color, depth, alpha, radii, num_instances = _RasterizeTiles.apply(
        means3d, scales, rotations, opacities, sh_dc, sh_rest,
        None if means2d_offset is None else means2d_offset.unsqueeze(0), cfg
    )
    # views of the chain's (1, ...) outputs, whose gradients are views too
    color, depth, alpha, radii = (x.squeeze(0) for x in (color, depth, alpha, radii))
    return RenderOutput(color, depth, alpha, radii, radii > 0, 0, num_instances)


def rasterize_tiles_multi(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: preprocess_fused.SH,
    cams: Sequence[RasterCamera],
    bg: torch.Tensor,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    means2d_offset: Optional[torch.Tensor] = None,
    active_degree: Optional[int] = None,
) -> RenderOutput:
    """Render the B cameras `cams` (one resolution) of the same Gaussians
    through one chain (module docstring): color (B, 3, H, W), depth and
    alpha (B, H, W), radii and visibility (B, N); num_instances is the
    chain's. `means2d_offset` is (B, N, 2), each camera's screen offset;
    the parameter gradients are summed over the cameras. SH path only, as
    `rasterize_tiles`."""
    sh_dc, sh_rest = _check_inputs(shs, None, None)
    if len({(c.height, c.width) for c in cams}) != 1:
        raise ValueError("the cameras of a chain must share one resolution")
    cfg = (tuple(cams), bg, sh_degree, float(scale_modifier), active_degree)
    color, depth, alpha, radii, num_instances = _RasterizeTiles.apply(
        means3d, scales, rotations, opacities, sh_dc, sh_rest, means2d_offset, cfg
    )
    return RenderOutput(color, depth, alpha, radii, radii > 0, 0, num_instances)
