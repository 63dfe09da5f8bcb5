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
    """The tile rasterizer is differentiable (the gradient reaches every
    input and the screen offset); precomputed colors / cov3D still raise."""
    cam, parts = setup(50, 3)
    t = [torch.from_numpy(p).requires_grad_(True) for p in parts]
    rc = raster_camera_from_numpy(cam)
    bg = torch.from_numpy(BG)
    off = torch.zeros((50, 2), requires_grad=True)
    out = raster_tiles.rasterize_tiles(*t, rc, bg, means2d_offset=off)
    (out.color.sum() + 0.1 * out.depth.sum() + out.alpha.sum()).backward()
    for p in t + [off]:
        assert p.grad is not None and p.grad.shape == p.shape
        assert torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0
    with torch.no_grad():
        assert raster_tiles.rasterize_tiles(*t, rc, bg).color.shape == (3, H, W)
    with pytest.raises(NotImplementedError):
        raster_tiles.rasterize_tiles(*t, rc, bg, colors_precomp=torch.zeros(50, 3))


def test_render_sh_pair_matches_concatenated():
    """render_gaussians hands the tile rasterizer the model's SH as the
    pair (features_dc, features_rest), which K1 and K2 read and write in
    place: the same image, and the same gradients of features_dc,
    features_rest and the screen offset, as the SH concatenated into one
    (N, 16, 3) tensor in front of the rasterizer."""
    from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
    from guidedvd3dgs_tpu_torch.models.render import render_gaussians

    xyz, log_scales, rots, opac_logit, sh = random_gaussians(n=400, seed=11)
    sh[:, 1:] = np.random.default_rng(11).normal(scale=0.3, size=sh[:, 1:].shape)
    cam = raster_camera_from_numpy(make_camera(height=H, width=W).raster_camera())
    bg = torch.from_numpy(BG)
    rng = np.random.default_rng(12)
    w_img = torch.from_numpy(rng.normal(size=(5, H, W)).astype(np.float32))

    def run(pair: bool):
        params = GaussianParams(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in
                                  (xyz, sh[:, :1], sh[:, 1:], log_scales, rots, opac_logit)))
        off = torch.zeros((400, 2), requires_grad=True)
        if pair:
            out = render_gaussians(params, cam, bg, 3, means2d_offset=off)
        else:
            n = torch.linalg.norm(params.rotation, dim=-1, keepdim=True)
            out = rasterize(params.xyz, torch.exp(params.scaling), params.rotation / torch.clamp(n, min=1e-12),
                            torch.sigmoid(params.opacity),
                            torch.cat([params.features_dc, params.features_rest], dim=1), cam, bg,
                            means2d_offset=off)
        img = torch.cat([out.color, out.depth[None], out.alpha[None]])
        (img * w_img).sum().backward()
        return img, params.features_dc.grad, params.features_rest.grad, off.grad, params.xyz.grad

    got, want = run(True), run(False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[1].abs().max()) > 0 and float(got[2].abs().max()) > 0


@pytest.mark.parametrize("sh_grad", [True, False])
def test_offset_gradient_whatever_else_requires_one(sh_grad):
    """The screen offset's gradient (densification's viewspace gradient)
    comes out whether or not the SH pair requires a gradient, and is the
    same either way."""
    cam, parts = setup(300, 5)
    rc = raster_camera_from_numpy(cam)
    t = [torch.from_numpy(p) for p in parts]
    sh = t[4]
    pair = (sh[:, :1].clone().requires_grad_(sh_grad), sh[:, 1:].clone().requires_grad_(sh_grad))
    off = torch.zeros((300, 2), requires_grad=True)
    out = raster_tiles.rasterize_tiles(*t[:4], pair, rc, torch.from_numpy(BG), means2d_offset=off)
    out.color.sum().backward()
    assert off.grad is not None and float(off.grad.abs().max()) > 0
    assert (pair[0].grad is not None) == sh_grad
    off_ref = torch.zeros((300, 2), requires_grad=True)
    ref = raster_tiles.rasterize_tiles(*t[:4], sh, rc, torch.from_numpy(BG), means2d_offset=off_ref)
    ref.color.sum().backward()
    assert torch.equal(off.grad, off_ref.grad)
