"""The backward of the port's tile rasterizer against the reference.

Plain versions of kernels K2 (preprocess VJP) and K6 (per-Gaussian
gradient sum) against the reference Pallas kernels in interpret mode, and
the whole `rasterize_tiles` gradient (K1 -> K3 + sort -> K4 forward,
K5 -> K6 -> K2 backward, all plain on the CPU) against the reference
tiles gradient in its exact mode, on the same numpy inputs. Tolerances:
  - K2: max abs error over max |grad| of each output 1e-5 (the same f32
    formulas, autodiff in another operation order); rows whose cotangent
    is zero (culled Gaussians, as the rasterizer hands them) get exactly 0;
  - K6: atol 1e-6 (the port sums in float64, the reference in f32);
  - the rasterizer gradient: max abs error over max |grad| 2e-4, the bound
    the reference holds its own tiles gradient against its dense one;
  - the port's dense backend (torch autograd) against its tiles: the same.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.ops import preprocess_pallas as jax_pp
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import segsum as jax_segsum
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu_torch.convert import raster_camera_from_numpy
from guidedvd3dgs_tpu_torch.ops import preprocess_fused, segsum
from guidedvd3dgs_tpu_torch.ops.raster import rasterize

from helpers import activated, make_camera, random_gaussians

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_exact():
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    jax_raster_tiles.set_pack_grads(False)
    yield
    jax_raster_tiles.set_interpret(prev)
    jax_tiling.set_pack_fields(True)
    jax_raster_tiles.set_pack_grads(True)


def normalised_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def k2_inputs(n, seed):
    xyz, log_s, rots, opac_logit, sh = random_gaussians(n=n, seed=seed)
    xyz[:6, 2] = -4.5  # behind the camera (at z = -4): culled
    xyz[6:9, 2] = -3.9  # in front of the camera, before the near plane
    xyz[9:15, :2] *= 6.0  # far off-axis: the FOV clip of the Jacobian is active
    sh[:, 1:] = np.random.default_rng(seed).normal(scale=0.3, size=sh[:, 1:].shape)
    return [np.ascontiguousarray(p, np.float32) for p in activated(xyz, log_s, rots, opac_logit, sh)]


@pytest.mark.parametrize("active", [1, 3])
def test_k2_plain_matches_reference(active):
    n = 400
    cam = make_camera(height=48, width=64).raster_camera()
    parts = k2_inputs(n, seed=5 + active)
    rng = np.random.default_rng(active)
    cot = rng.normal(size=(10, n)).astype(np.float32)
    tab = preprocess_fused.preprocess_table_plain(
        *map(torch.from_numpy, parts), raster_camera_from_numpy(cam), 3, 1.0)
    culled = ~(tab[11] > 0.5).numpy()
    assert culled.sum() >= 9
    cot[:, culled] = 0.0  # the rasterizer hands culled Gaussians no cotangent

    ref = jax_pp.preprocess_fused_bwd(
        *map(jnp.asarray, parts), cam, 3, 1.0, jnp.asarray(cot), active_degree=float(active))
    got = preprocess_fused.preprocess_fused_bwd(
        *map(torch.from_numpy, parts), raster_camera_from_numpy(cam), 3, 1.0,
        torch.from_numpy(cot), active_degree=active)
    for name, g, r in zip(("means", "scales", "rotations", "opacity", "shs"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        assert normalised_err(g.numpy(), r) <= 1e-5, (name, normalised_err(g.numpy(), r))
        assert (g.numpy()[culled] == 0.0).all(), name
    # bands above the active degree get no gradient
    assert (got[4].numpy()[:, (active + 1) ** 2:] == 0.0).all()


def test_k6_plain_matches_reference():
    rng = np.random.default_rng(0)
    n = 700
    count = rng.integers(1, 6, size=n).astype(np.int32)
    m = int(count.sum())
    mpad = -(-m // jax_segsum.BBLK) * jax_segsum.BBLK
    grads = rng.normal(size=(mpad, 10)).astype(np.float32)
    ids = np.full(mpad, n, np.int32)  # padding slots carry id n
    ids[:m] = np.repeat(np.arange(n, dtype=np.int32), count)
    offsets = (np.cumsum(count) - count).astype(np.int32)
    ref = jax_segsum.segment_sum_sorted(
        jnp.asarray(ids), tuple(jnp.asarray(grads[:, f]) for f in range(10)), n)
    got = segsum.segment_sum_sorted(
        torch.from_numpy(grads[:m]), torch.from_numpy(offsets), torch.from_numpy(count))
    assert got.shape == (10, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


HT, WT = 32, 48
NAMES = ("xyz", "scales", "rots", "opac", "sh", "offset")


def raster_setup():
    cam = make_camera(height=HT, width=WT).raster_camera()
    parts = [np.ascontiguousarray(p, np.float32) for p in activated(*random_gaussians(n=200, seed=3))]
    return cam, parts


def loss_of(out, target):
    return ((out.color - target) ** 2).sum() + 0.1 * out.depth.sum() + 0.05 * (out.alpha ** 2).sum()


def port_grads(cam, parts, backend):
    t = [torch.from_numpy(p).requires_grad_(True) for p in parts]
    off = torch.zeros((parts[0].shape[0], 2), requires_grad=True)
    out = rasterize(*t, raster_camera_from_numpy(cam), torch.zeros(3), backend=backend,
                    means2d_offset=off)
    loss_of(out, torch.full((3, HT, WT), 0.3)).backward()
    return [p.grad.numpy() for p in t + [off]]


def test_tiles_gradient_matches_reference():
    cam, parts = raster_setup()
    bg, target = jnp.zeros(3), jnp.full((3, HT, WT), 0.3)

    def loss_ref(xyz, scales, rots, opac, sh, off):
        out = jax_raster_tiles.rasterize_tiles(xyz, scales, rots, opac, sh, cam, bg, means2d_offset=off)
        return loss_of(out, target)

    ref = jax.grad(loss_ref, argnums=tuple(range(6)))(
        *map(jnp.asarray, parts), jnp.zeros((parts[0].shape[0], 2)))
    got = port_grads(cam, parts, "tiles")
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == np.asarray(r).shape, name
        assert np.isfinite(g).all(), name
        assert normalised_err(g, r) <= 2e-4, (name, normalised_err(g, r))
    assert np.abs(got[-1]).max() > 0  # the viewspace gradient densification reads


def test_dense_gradient_matches_tiles():
    cam, parts = raster_setup()
    tiles = port_grads(cam, parts, "tiles")
    dense = port_grads(cam, parts, "dense")
    for name, d, t in zip(NAMES, dense, tiles):
        assert normalised_err(d, t) <= 2e-4, (name, normalised_err(d, t))
    assert math.isfinite(float(np.abs(tiles[0]).sum()))
