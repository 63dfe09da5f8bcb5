"""Kernel K1's plain version against the reference preprocess.

The port's (16, N) table (ops/preprocess_fused.py, CPU path) is compared
with the reference Pallas kernel `preprocess_fused_fwd` in interpret mode
and with the reference XLA `preprocess_gaussians`, on the same numpy
inputs. Both compute the same f32 formulas, so they differ only by
operation order: rows 0-9, 12 and 13 agree to 1e-5, visibility exactly,
and the radius (a ceil) wherever 3 sqrt(lambda1) is not within 1e-4 of an
integer.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.ops import preprocess_pallas as jpp
from guidedvd3dgs_tpu.ops.projection import RasterCamera as JaxCamera
from guidedvd3dgs_tpu.ops.projection import preprocess_gaussians as jax_preprocess
from guidedvd3dgs_tpu.utils.graphics import getProjectionMatrix, getWorld2View2
from guidedvd3dgs_tpu.utils.sh import eval_sh as jax_eval_sh
from guidedvd3dgs_tpu_torch.convert import raster_camera_from_numpy
from guidedvd3dgs_tpu_torch.ops import preprocess_fused, tiling
from guidedvd3dgs_tpu_torch.utils.sh import RGB2SH, SH2RGB, eval_sh

torch.set_num_threads(2)

ATOL = RTOL = 1e-5
FIELD_ROWS = list(range(10)) + [12, 13]


@pytest.fixture(autouse=True)
def _interpret():
    prev = jpp._INTERPRET[0]
    jpp.set_interpret(True)
    yield
    jpp.set_interpret(prev)


def make_cam(h=64, w=96):
    fov = math.radians(60)
    R = np.eye(3, dtype=np.float32)
    view = np.asarray(getWorld2View2(R, np.array([0.1, -0.2, 0.3], np.float32))).T
    proj = np.asarray(getProjectionMatrix(0.01, 100.0, fov, fov * h / w)).T
    return JaxCamera(
        jnp.asarray(view), jnp.asarray(view @ proj),
        jnp.asarray(np.linalg.inv(view.T)[:3, 3]),
        math.tan(fov / 2), math.tan(fov * h / w / 2), h, w,
    )


def make_scene(n=500, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    means[:7, 2] = -1.0  # behind the camera: the cull and safe-where path
    means[7:10, 2] = 0.05  # in front of the camera but before the near plane
    scales = np.exp(rng.uniform(-5.5, -3.0, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(size=(n, 1)) * 2))).astype(np.float32)
    opac[10:13] = 1e-3  # below 1/255: ext sentinel -16
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return means, scales, rots, opac, shs


def _radius_close_to_integer(table):
    """3 sqrt(lambda1) of each Gaussian, rebuilt in float64 from its conic."""
    a, b, c = (table[i].astype(np.float64) for i in (2, 3, 4))
    det_c = a * c - b * b
    cxx, cxy, cyy = c / det_c, -b / det_c, a / det_c
    mid = 0.5 * (cxx + cyy)
    lam = mid + np.sqrt(np.maximum(0.1, mid * mid - (cxx * cyy - cxy * cxy)))
    v = 3.0 * np.sqrt(lam)
    return np.abs(v - np.round(v)) < 1e-4


def _compare_tables(port, ref):
    np.testing.assert_allclose(port[FIELD_ROWS], ref[FIELD_ROWS], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(port[11], ref[11])
    bad = port[10] != ref[10]
    assert not (bad & ~_radius_close_to_integer(port)).any(), np.nonzero(bad)


@pytest.mark.parametrize(
    "sh_degree,active_degree,scale_modifier",
    [(0, None, 1.0), (1, 0, 0.7), (3, None, 1.0), (3, 2, 1.3)],
)
def test_k1_plain_matches_reference_kernel(sh_degree, active_degree, scale_modifier):
    cam = make_cam()
    arrays = make_scene()
    ref = np.asarray(
        jpp.preprocess_fused_fwd(
            *map(jnp.asarray, arrays), cam, sh_degree, scale_modifier,
            active_degree=None if active_degree is None else jnp.float32(active_degree),
        )
    )
    port = preprocess_fused.preprocess_fused_fwd(
        *map(torch.from_numpy, arrays), raster_camera_from_numpy(cam),
        sh_degree, scale_modifier, active_degree=active_degree,
    ).numpy()
    assert port.shape == ref.shape == (16, arrays[0].shape[0])
    assert 0 < port[11].sum() < port.shape[1]  # some culled, most visible
    assert (port[12] == -16.0).sum() >= 3
    _compare_tables(port, ref)


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_k1_plain_matches_reference_xla_preprocess(sh_degree):
    cam = make_cam()
    arrays = make_scene(seed=4)
    proc = jax_preprocess(*map(jnp.asarray, arrays), cam, sh_degree=sh_degree, scale_modifier=0.9)
    port = preprocess_fused.preprocess_table_plain(
        *map(torch.from_numpy, arrays), raster_camera_from_numpy(cam), sh_degree, 0.9
    ).numpy()
    vis = np.asarray(proc.visible)
    ref = np.zeros_like(port)
    ref[0:2] = np.asarray(proc.means2d).T
    ref[2:5] = np.asarray(proc.conics).T
    ref[5] = np.asarray(proc.opacities)
    ref[6:9] = np.asarray(proc.colors).T
    ref[9] = np.asarray(proc.depths)
    ref[11] = vis
    ref[12] = np.asarray(proc.ext_x)
    ref[13] = np.asarray(proc.ext_y)
    radii = np.asarray(proc.radii)
    ref[10] = np.where(vis, radii, port[10])  # the reference masks radius by visibility
    _compare_tables(port, ref)


def edge_scene(n=2000, seed=5):
    """make_scene's Gaussians spread past every edge of make_cam's 96x64
    view (screen x from about -100 to 200), a few behind the camera."""
    means, scales, rots, opac, shs = make_scene(n, seed)
    rng = np.random.default_rng(seed)
    means[10:, :2] = rng.uniform(-3.5, 3.5, (n - 10, 2)).astype(np.float32)
    scales[10:] = np.exp(rng.uniform(-4.0, -1.0, (n - 10, 3))).astype(np.float32)
    return means, scales, rots, opac, shs


@pytest.mark.parametrize("sh_degree,active_degree", [(3, None), (2, 1), (0, None)])
def test_k1_plain_skip_zeroes_only_unbinned_colour(sh_degree, active_degree):
    """With skip_unbinned (and the SH as the model's pair) K1's plain
    version equals the full table on every row, rows 6-8 aside: those are
    exactly 0 where ops/tiling.py::tile_rects counts no tile and unchanged
    elsewhere. The view has Gaussians past each image edge, with and
    without a tile, and behind the camera."""
    cam = raster_camera_from_numpy(make_cam())
    means, scales, rots, opac, shs = map(torch.from_numpy, edge_scene())
    full = preprocess_fused.preprocess_table_plain(means, scales, rots, opac, shs, cam, sh_degree, 0.9,
                                                   active_degree)
    pair = (shs[:, :1].clone(), shs[:, 1:].clone())
    skip = preprocess_fused.preprocess_fused_fwd(means, scales, rots, opac, pair, cam, sh_degree, 0.9,
                                                 active_degree, skip_unbinned=True)
    count = tiling.tile_rects(full[0], full[1], preprocess_fused.visible_radii(full), full[12], full[13],
                              cam.width, cam.height)[4]
    binned = count > 0
    rgb = slice(preprocess_fused.F_R, preprocess_fused.F_D)
    others = [r for r in range(preprocess_fused.NUM_ROWS) if r not in range(6, 9)]
    assert torch.equal(skip[others], full[others])
    assert torch.equal(skip[rgb][:, binned], full[rgb][:, binned])
    assert not skip[rgb][:, ~binned].any()
    assert bool((full[rgb][:, ~binned] > 0).any())  # the skip changed something
    x, y, w, h = full[0], full[1], cam.width, cam.height
    for outside in (x < 0, x >= w, y < 0, y >= h):  # every edge: Gaussians with and without a tile
        assert bool((outside & binned).any()) and bool((outside & ~binned).any())
    assert bool((full[11] == 0).any())  # behind the camera


def test_k1_plain_offset_adds_to_reference_rows():
    """K1 with means2d_offset: the reference kernel's rows 0-1 plus the
    offset times (W/2, H/2), the other rows the reference's."""
    jcam = make_cam()
    arrays = make_scene(seed=6)
    ref = np.array(jpp.preprocess_fused_fwd(*map(jnp.asarray, arrays), jcam, 3, 1.0))
    off = np.random.default_rng(6).normal(scale=0.05, size=(arrays[0].shape[0], 2)).astype(np.float32)
    ref[0] = ref[0] + off[:, 0] * np.float32(0.5 * jcam.width)
    ref[1] = ref[1] + off[:, 1] * np.float32(0.5 * jcam.height)
    port = preprocess_fused.preprocess_fused_fwd(
        *map(torch.from_numpy, arrays), raster_camera_from_numpy(jcam), 3, 1.0,
        means2d_offset=torch.from_numpy(off),
    ).numpy()
    assert np.abs(off[:, 0] * 0.5 * jcam.width).max() > 1.0  # the offset moves the means
    _compare_tables(port, ref)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_reference(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(64, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = np.asarray(jax_eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    port = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)
    rgb = torch.rand(10, 3)
    torch.testing.assert_close(SH2RGB(RGB2SH(rgb)), rgb)
