"""Precomputed colours and cov3D on the port's tile rasterizer, against the
JAX package on the CPU.

The port's path: the table from the plain preprocess, K3 + sort and K4
forward, K5 and K6 backward, the table's gradient through the plain
preprocess (plain versions on the CPU). The reference: JAX's
`rasterize_tiles` with the same arguments, its Pallas kernels in interpret
mode and its exact fields (`tiling.set_pack_fields(False)`), on the same
numpy inputs. Tolerances, those of tests/test_torch_backward.py: images
within 1e-5 absolute; every gradient within 2e-4 of its largest magnitude
(the bound the reference holds its tiles gradient to against its dense
one). `render_gaussians(override_color=...)` on the tile backend is held
to JAX's and to the port's dense backend by the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.models import render as jrender
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu_torch.convert import raster_camera_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import GaussianParams
from guidedvd3dgs_tpu_torch.models.render import render_gaussians
from guidedvd3dgs_tpu_torch.ops.raster_tiles import rasterize_tiles

from helpers import activated, make_camera, random_gaussians

torch.set_num_threads(2)

HT, WT = 32, 48
IMG_TOL = 1e-5
GRAD_TOL = 2e-4


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


def cov3d_of(scales, rots):
    """The packed (N, 6) covariance R S S^T R^T of activated scales and
    unit quaternions (w, x, y, z)."""
    w, x, y, z = rots.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    L = R * scales[:, None, :]
    S = L @ L.transpose(0, 2, 1)
    return np.stack([S[:, 0, 0], S[:, 0, 1], S[:, 0, 2], S[:, 1, 1], S[:, 1, 2], S[:, 2, 2]], -1)


def inputs(seed=3):
    """xyz, scales, rots, opac, sh (activated), colours (N, 3), cov3D (N, 6)
    a little apart from the scales' own (so a mix-up shows), offsets."""
    parts = [np.ascontiguousarray(p, np.float32) for p in activated(*random_gaussians(n=200, seed=seed))]
    rng = np.random.default_rng(seed)
    n = parts[0].shape[0]
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    cov = (cov3d_of(parts[1].astype(np.float64) * 1.3, parts[2].astype(np.float64))).astype(np.float32)
    off = np.zeros((n, 2), np.float32)
    return parts, colors, cov, off


def loss_of(out, target):
    return ((out.color - target) ** 2).sum() + 0.1 * out.depth.sum() + 0.05 * (out.alpha ** 2).sum()


CASES = {"colors": (True, False), "cov3d": (False, True), "both": (True, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_precomputed_inputs_match_reference(case):
    use_col, use_cov = CASES[case]
    cam = make_camera(height=HT, width=WT).raster_camera()
    parts, colors, cov, off = inputs()
    xyz, scales, rots, opac, sh = parts
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    target = np.full((3, HT, WT), 0.3, np.float32)
    # the differentiated inputs: xyz, opacity, offset, and colours or SH,
    # cov3D or scales and rotations
    names = ["xyz", "opac", "offset"] + (["colors"] if use_col else ["sh"]) + \
        (["cov3d"] if use_cov else ["scales", "rots"])
    values = dict(xyz=xyz, opac=opac, offset=off, colors=colors, sh=sh, cov3d=cov, scales=scales, rots=rots)

    def call(fn, arrays, **fixed):
        a = {**fixed, **arrays}
        return fn(a["xyz"], a["scales"], a["rots"], a["opac"], None if use_col else a["sh"],
                  colors_precomp=a["colors"] if use_col else None,
                  cov3d_precomp=a["cov3d"] if use_cov else None, means2d_offset=a["offset"])

    fixed_j = {k: jnp.asarray(v) for k, v in values.items() if k not in names}

    def ref_fn(*diff):
        out = call(lambda *a, **k: jax_raster_tiles.rasterize_tiles(*a, cam, jnp.asarray(bg), **k),
                   dict(zip(names, diff)), **fixed_j)
        return loss_of(out, jnp.asarray(target)), out

    (_, ref_out), ref = jax.value_and_grad(ref_fn, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(values[k]) for k in names])

    t = {k: torch.from_numpy(values[k]).requires_grad_(k in names) for k in values}
    out = call(lambda *a, **k: rasterize_tiles(*a, raster_camera_from_numpy(cam), torch.from_numpy(bg), **k), t)
    loss_of(out, torch.from_numpy(target)).backward()

    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(), np.asarray(getattr(ref_out, name)),
                                   atol=IMG_TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref_out.radii))
    assert float(out.alpha.detach().max()) > 0.5
    for name, r in zip(names, ref):
        g = t[name].grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        assert normalised_err(g, r) <= GRAD_TOL, (name, normalised_err(g, r))


def test_override_color_renders_on_the_tile_backend():
    cam = make_camera(height=HT, width=WT).raster_camera()
    colors = inputs(seed=4)[1]
    xyz, scales, rots, opac, sh = random_gaussians(n=200, seed=4)  # raw: render_gaussians activates
    raw = dict(xyz=xyz, features_dc=sh[:, :1], features_rest=sh[:, 1:], scaling=scales, rotation=rots,
               opacity=opac)
    target = np.full((3, HT, WT), 0.3, np.float32)

    def ref_loss(params, override):
        out = jrender.render_gaussians(params, jnp.ones(len(xyz), bool), jnp.ones((len(xyz), 1)), cam,
                                       jnp.zeros(3), 3, override_color=override, backend="tiles")
        return loss_of(out, jnp.asarray(target)), out

    jparams = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in raw.items()})
    (_, ref_out), (gp, gc) = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(colors))

    results = {}
    for backend in ("tiles", "dense"):
        params = GaussianParams(*(torch.from_numpy(np.ascontiguousarray(raw[k])) for k in raw))
        override = torch.from_numpy(colors).requires_grad_(True)
        out = render_gaussians(params, raster_camera_from_numpy(cam), torch.zeros(3), 3,
                               override_color=override, backend=backend)
        loss_of(out, torch.from_numpy(target)).backward()
        results[backend] = (out, {k: getattr(params, k).grad for k in raw}, override.grad.numpy())
    out, grads, g_col = results["tiles"]
    np.testing.assert_allclose(out.color.detach().numpy(), np.asarray(ref_out.color), atol=IMG_TOL, rtol=0)
    assert out.num_instances > 0
    # the SH is not read: no gradient reaches it
    assert grads["features_dc"] is None and grads["features_rest"] is None
    assert not np.asarray(gp.features_dc).any() and not np.asarray(gp.features_rest).any()
    for name in ("xyz", "scaling", "rotation", "opacity"):
        assert normalised_err(grads[name].numpy(), getattr(gp, name)) <= GRAD_TOL, name
        assert normalised_err(grads[name].numpy(), results["dense"][1][name].numpy()) <= GRAD_TOL, name
    assert normalised_err(g_col, gc) <= GRAD_TOL
    assert normalised_err(g_col, results["dense"][2]) <= GRAD_TOL
