"""The port's tile rasterizer (CPU path: plain K1, K3 + sort, plain K4)
against the reference renderers, at 72x56 on the same numpy inputs.

Tolerances:
  - against the reference dense oracle: color and alpha atol 2e-5 /
    rtol 1e-4, depth atol 2e-4 / rtol 1e-4, as the reference holds its
    own tiles against dense (same f32 blend rule, other operation order);
  - against the reference tiles renderer (interpret mode, exact fields):
    color and alpha atol 5e-5, depth atol 5e-4 (that renderer still
    rebuilds depth from its quantized sort key);
  - the port's "dense" backend against its "tiles" backend: the first pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.ops.raster_dense import rasterize_dense as jax_rasterize_dense
from guidedvd3dgs_tpu_torch.convert import raster_camera_from_numpy
from guidedvd3dgs_tpu_torch.ops import raster_tiles
from guidedvd3dgs_tpu_torch.ops.raster import rasterize

from helpers import activated, make_camera, random_gaussians

torch.set_num_threads(2)

W, H = 72, 56
BG = np.array([0.2, 0.4, 0.6], np.float32)


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


def setup(n, seed, opaque=False):
    cam = make_camera(height=H, width=W).raster_camera()
    parts = [np.ascontiguousarray(p, np.float32) for p in activated(*random_gaussians(n=n, seed=seed))]
    if opaque:  # heavy overlap: pixels reach the T < 1e-4 stop
        parts[3] = np.clip(parts[3] * 4.0, 0.0, 0.999).astype(np.float32)
    return cam, parts


def port_render(cam, parts, backend="tiles"):
    return rasterize(
        *map(torch.from_numpy, parts), raster_camera_from_numpy(cam), torch.from_numpy(BG),
        backend=backend,
    )


def assert_close(port, ref, atol_ca, atol_d, rtol):
    np.testing.assert_allclose(port.color.numpy(), np.asarray(ref.color), atol=atol_ca, rtol=rtol)
    np.testing.assert_allclose(port.alpha.numpy(), np.asarray(ref.alpha), atol=atol_ca, rtol=rtol)
    np.testing.assert_allclose(port.depth.numpy(), np.asarray(ref.depth), atol=atol_d, rtol=rtol)
    np.testing.assert_array_equal(port.radii.numpy(), np.asarray(ref.radii))


@pytest.mark.parametrize("n,seed,opaque", [(300, 0, False), (2000, 1, False), (400, 9, True)])
def test_tiles_match_reference_dense(n, seed, opaque):
    cam, parts = setup(n, seed, opaque)
    ref = jax_rasterize_dense(*map(jnp.asarray, parts), cam, jnp.asarray(BG))
    port = port_render(cam, parts)
    assert port.color.shape == (3, H, W) and port.depth.shape == (H, W)
    assert port.num_instances > 0 and port.overflow == 0
    assert float(port.color.std()) > 0.01  # not a blank image
    if opaque:
        assert float(port.alpha.max()) > 0.999  # the stop rule was reached
    assert_close(port, ref, 2e-5, 2e-4, 1e-4)
    dense = port_render(cam, parts, backend="dense")
    assert_close(dense, port, 2e-5, 2e-4, 1e-4)


@pytest.mark.parametrize("n,seed", [(300, 0), (2000, 1)])
def test_tiles_match_reference_tiles(n, seed):
    cam, parts = setup(n, seed)
    ref = jax_raster_tiles.rasterize_tiles(*map(jnp.asarray, parts), cam, jnp.asarray(BG))
    port = port_render(cam, parts)
    assert_close(port, ref, 5e-5, 5e-4, 0.0)


def test_tiles_refuse_what_needs_a_backward():
    cam, parts = setup(50, 3)
    t = [torch.from_numpy(p) for p in parts]
    rc = raster_camera_from_numpy(cam)
    bg = torch.from_numpy(BG)
    t[0].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        raster_tiles.rasterize_tiles(*t, rc, bg)
    with torch.no_grad():
        assert raster_tiles.rasterize_tiles(*t, rc, bg).color.shape == (3, H, W)
        with pytest.raises(NotImplementedError):
            raster_tiles.rasterize_tiles(*t, rc, bg, colors_precomp=torch.zeros(50, 3))
