"""Per-Gaussian preprocessing: EWA projection, conic, SH color.

Counterpart of `guidedvd3dgs_tpu/ops/projection.py`, written as plain torch
over per-component (N,) tensors in the same operation order, so that the
port and the reference agree to f32 rounding. It is the plain version of
kernel K1 (ops/preprocess_fused.py, csrc/preprocess_fwd.cu).

Matrix layout follows the reference: `viewmatrix`/`projmatrix` are stored
transposed (row-vector convention, points multiply from the left).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from guidedvd3dgs_tpu_torch.utils.sh import C0, C1, C2, C3

NEAR_CLIP = 0.2  # p_view.z <= 0.2 is culled
COV2D_DILATION = 0.3  # low-pass filter added to the 2D covariance
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99


@dataclasses.dataclass
class RasterCamera:
    """Camera as the rasterizer takes it.

    viewmatrix: (4, 4) f32 transposed world-to-view
    projmatrix: (4, 4) f32 transposed full projection (world -> clip)
    campos: (3,) f32 camera center in world space
    """

    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tanfovx: float
    tanfovy: float
    height: int
    width: int

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device


class ProcessedGaussians(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coordinates
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # (N,) int32 screen radius; 0 => culled
    colors: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N,)
    visible: torch.Tensor  # (N,) bool
    # Tight per-axis binning extents in pixels: half-widths of the bbox of
    # the alpha >= 1/255 level set, capped at the 3-sigma radius; -16 marks
    # a Gaussian whose opacity is below 1/255 (never visible).
    ext_x: torch.Tensor  # (N,) f32
    ext_y: torch.Tensor  # (N,) f32


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _cov3d_components(s_t, scale_modifier, q_t):
    """Sigma = R S S^T R^T from component tuples s_t = (sx, sy, sz) and
    q_t = (qr, qx, qy, qz); returns (xx, xy, xz, yy, yz, zz)."""
    norm = torch.sqrt(
        torch.clamp(
            q_t[0] * q_t[0] + q_t[1] * q_t[1] + q_t[2] * q_t[2] + q_t[3] * q_t[3],
            min=1e-20,
        )
    )
    r = q_t[0] / norm
    x = q_t[1] / norm
    y = q_t[2] / norm
    z = q_t[3] / norm
    R = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )
    # a runaway scale is clamped so the covariance stays finite
    s = tuple(torch.clamp(scale_modifier * s_t[i], max=1e9) for i in range(3))
    s2 = (s[0] * s[0], s[1] * s[1], s[2] * s[2])

    def sig(a, b):
        return (
            s2[0] * R[a][0] * R[b][0]
            + s2[1] * R[a][1] * R[b][1]
            + s2[2] * R[a][2] * R[b][2]
        )

    return (sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2))


def _cov2d_components(tx, ty, tz, cov3d, W, tanfovx, tanfovy, width, height):
    """EWA projection of the 3D covariance with the 0.3 low-pass; W is the
    3x3 view rotation as nested tuples of 0-dim tensors."""
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txtz = torch.clamp(tx / tz, -limx, limx) * tz
    tytz = torch.clamp(ty / tz, -limy, limy) * tz

    j00 = focal_x / tz
    j11 = focal_y / tz
    j20 = -(focal_x * txtz) / (tz * tz)
    j21 = -(focal_y * tytz) / (tz * tz)

    u = tuple(W[r][0] * j00 + W[r][2] * j20 for r in range(3))
    v = tuple(W[r][1] * j11 + W[r][2] * j21 for r in range(3))

    c0, c1, c2, c3, c4, c5 = cov3d

    def quad(a, b):
        return (
            c0 * a[0] * b[0]
            + c3 * a[1] * b[1]
            + c5 * a[2] * b[2]
            + c1 * (a[0] * b[1] + a[1] * b[0])
            + c2 * (a[0] * b[2] + a[2] * b[0])
            + c4 * (a[1] * b[2] + a[2] * b[1])
        )

    return (quad(u, u) + COV2D_DILATION, quad(u, v), quad(v, v) + COV2D_DILATION)


def _eval_sh_channels(deg: int, sh48, dx, dy, dz, active_degree: Optional[int]):
    """SH at unit directions over component tensors; bands above
    `active_degree` get a zero basis."""
    if not 0 <= deg <= 3:
        raise ValueError(f"rasterizer SH degree {deg} not in [0, 3]")
    bs = [1.0] + [
        1.0 if active_degree is None or active_degree >= b else 0.0 for b in (1, 2, 3)
    ]
    basis = [torch.full_like(dx, C0)]
    if deg > 0:
        basis += [bs[1] * -C1 * dy, bs[1] * C1 * dz, bs[1] * -C1 * dx]
        if deg > 1:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            xy, yz, xz = dx * dy, dy * dz, dx * dz
            basis += [
                bs[2] * C2[0] * xy, bs[2] * C2[1] * yz,
                bs[2] * C2[2] * (2.0 * zz - xx - yy),
                bs[2] * C2[3] * xz, bs[2] * C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    bs[3] * C3[0] * dy * (3 * xx - yy),
                    bs[3] * C3[1] * xy * dz,
                    bs[3] * C3[2] * dy * (4 * zz - xx - yy),
                    bs[3] * C3[3] * dz * (2 * zz - 3 * xx - 3 * yy),
                    bs[3] * C3[4] * dx * (4 * zz - xx - yy),
                    bs[3] * C3[5] * dz * (xx - yy),
                    bs[3] * C3[6] * dx * (xx - 3 * yy),
                ]
    out = []
    for ch in range(3):
        acc = basis[0] * sh48[0][ch]
        for k in range(1, len(basis)):
            acc = acc + basis[k] * sh48[k][ch]
        out.append(acc)
    return out


def preprocess_field_rows(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    cam: RasterCamera,
    sh_degree: int,
    scale_modifier: float,
    active_degree: Optional[int] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
):
    """Per-Gaussian preprocess as component rows.

    means3d/scales (N, 3), rotations (N, 4), opacities (N,) or (N, 1),
    shs (N, K, 3) with K >= (sh_degree + 1)**2, all post-activation.
    Returns (fields10, radius, visible, ext_x, ext_y):
      fields10 = (mx2d, my2d, conic_a, conic_b, conic_c, op, r, g, b, depth),
      the render-field rows in ops/preprocess_fused.py F_* order; radius and the
      extents are for binning; visible is in-front & invertible.
    """
    V, P = cam.viewmatrix, cam.projmatrix
    Vt = tuple(tuple(V[r, c] for c in range(4)) for r in range(4))
    Pm = tuple(tuple(P[r, c] for c in range(4)) for r in range(4))
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    op_row = opacities.reshape(means3d.shape[0], -1)[:, 0]
    width, height = cam.width, cam.height

    def xform(mat, col):
        return mx * mat[0][col] + my * mat[1][col] + mz * mat[2][col] + mat[3][col]

    tvx, tvy, tvz = xform(Vt, 0), xform(Vt, 1), xform(Vt, 2)
    ph_x, ph_y, ph_w = xform(Pm, 0), xform(Pm, 1), xform(Pm, 3)

    in_front = tvz > NEAR_CLIP

    # Safe-where guards: every row is evaluated, so a culled Gaussian at
    # z == 0 or with a singular covariance must still produce finite values
    # (a NaN in the table would reach the binning arithmetic).
    tz_safe = torch.where(in_front, tvz, torch.ones_like(tvz))
    p_w = 1.0 / torch.where(in_front, ph_w + 1e-7, torch.ones_like(ph_w))

    if cov3d_precomp is None:
        cov3d = _cov3d_components(
            tuple(scales[:, i] for i in range(3)),
            scale_modifier,
            tuple(rotations[:, i] for i in range(4)),
        )
    else:
        cov3d = tuple(cov3d_precomp[:, i] for i in range(6))
    W3 = tuple(tuple(Vt[r][c] for c in range(3)) for r in range(3))
    cxx, cxy, cyy = _cov2d_components(
        tvx, tvy, tz_safe, cov3d, W3, cam.tanfovx, cam.tanfovy, width, height
    )

    det = cxx * cyy - cxy * cxy
    # isfinite: exploding scales must cull, not NaN the conic
    det_ok = (det != 0.0) & torch.isfinite(det)
    cxx_s = torch.where(det_ok, cxx, torch.ones_like(cxx))
    cxy_s = torch.where(det_ok, cxy, torch.zeros_like(cxy))
    cyy_s = torch.where(det_ok, cyy, torch.ones_like(cyy))
    det_s = cxx_s * cyy_s - cxy_s * cxy_s
    det_inv = 1.0 / det_s
    conic = (cyy_s * det_inv, -cxy_s * det_inv, cxx_s * det_inv)

    mid = 0.5 * (cxx_s + cyy_s)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det_s, min=0.1))
    # capped below the int32 range
    radius = torch.clamp(
        torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-12))), max=2.0**30
    )

    # tight binning extents; the 1.001 factor keeps the bbox conservative
    # under f32 rounding
    lvl = torch.log(torch.clamp(op_row, min=1e-12) * 255.0)
    ever_visible = lvl > 0.0
    ext_x = torch.minimum(
        torch.sqrt(torch.clamp(2.0 * lvl * cxx_s, min=0.0)) * 1.001, radius
    )
    ext_y = torch.minimum(
        torch.sqrt(torch.clamp(2.0 * lvl * cyy_s, min=0.0)) * 1.001, radius
    )
    ext_x = torch.where(ever_visible, ext_x, torch.full_like(ext_x, -16.0))
    ext_y = torch.where(ever_visible, ext_y, torch.full_like(ext_y, -16.0))

    mx2d = ndc2pix(ph_x * p_w, width)
    my2d = ndc2pix(ph_y * p_w, height)

    if colors_precomp is None:
        n_coef = (sh_degree + 1) ** 2
        if shs.shape[1] < n_coef:
            raise ValueError(f"shs has {shs.shape[1]} coefficients, degree {sh_degree} needs {n_coef}")
        sh48 = [(shs[:, k, 0], shs[:, k, 1], shs[:, k, 2]) for k in range(n_coef)]
        campos = cam.campos
        dx = mx - campos[0]
        dy = my - campos[1]
        dz = mz - campos[2]
        # a mean at the camera center is culled, but its row stays finite
        inv_n = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-20))
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        r, g, b = _eval_sh_channels(sh_degree, sh48, dx, dy, dz, active_degree)
        cr = torch.clamp(r + 0.5, min=0.0)
        cg = torch.clamp(g + 0.5, min=0.0)
        cb = torch.clamp(b + 0.5, min=0.0)
    else:
        cr, cg, cb = (colors_precomp[:, i] for i in range(3))

    visible = in_front & det_ok
    fields10 = (mx2d, my2d, conic[0], conic[1], conic[2], op_row, cr, cg, cb, tvz)
    return fields10, radius, visible, ext_x, ext_y


def preprocess_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    cam: RasterCamera,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    active_degree: Optional[int] = None,
) -> ProcessedGaussians:
    """Project N Gaussians to screen space (inputs post-activation)."""
    fields10, radius, visible, ext_x, ext_y = preprocess_field_rows(
        means3d, scales, rotations, opacities, shs, cam, sh_degree, scale_modifier,
        active_degree=active_degree, colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
    )
    mx2d, my2d, ca, cb, cc, op_row, cr, cg, cbl, depths = fields10
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    return ProcessedGaussians(
        means2d=torch.stack([mx2d, my2d], dim=-1),
        depths=depths,
        conics=torch.stack([ca, cb, cc], dim=-1),
        radii=radii,
        colors=torch.stack([cr, cg, cbl], dim=-1),
        opacities=op_row,
        visible=visible,
        ext_x=ext_x,
        ext_y=ext_y,
    )
