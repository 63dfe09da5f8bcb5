"""The B-camera chain of the port's tile rasterizer against the JAX
package's, and against B single renders of the port, on the CPU.

`ops/raster_tiles.py::rasterize_tiles_multi` (all plain versions here: K1
per camera into one table, K3 + sort + K4 over the cameras' bands, K5 + K6
over the chain, K2 per camera with its accumulate mode) is held to JAX's
`rasterize_tiles_multi` in interpret mode with both packings off (its
exact arithmetic) at B = 2 and 5: a 64x48 view, 300 Gaussians, a dozen of
them large and at the images' top and bottom edges (their rectangles are
clamped at a band's edge), and at B = 5 one camera behind every Gaussian
(it sees nothing). Tolerances: color and alpha 1e-5 absolute, depth 1e-4
(JAX's own test of its chain against its single renders; JAX shifts each
camera's screen means by its band, which rounds them in f32, the port
keeps them), radii equal; the gradients of means, scales, rotations,
opacity, the SH pair and the (B, N, 2) screen offsets within 2e-4 of their
largest magnitude (tests/test_torch_backward.py's tile gradient).

Against the port's B single renders: the images and radii equal, the
offsets' gradients (each camera's own K6 rows) equal, the parameters'
gradients within 1e-5 of their largest magnitude (the chain adds the
cameras' K2 outputs before the activations' backward, single renders
after). At B = 2 the SH pair's gradient is the sum over both cameras: a
K2 that wrote instead of adding would leave the second camera's alone.

`FrozenRenderer.render_many` of 7 frames (a group of 5, then a short one
of 2) against JAX's `_render_many` (its last group padded): color and
alpha 1e-5, depth 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.parallel.data_parallel import stack_cameras
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch.convert import params_from_numpy, raster_camera_from_numpy
from guidedvd3dgs_tpu_torch.ops import raster_tiles
from guidedvd3dgs_tpu_torch.ops.raster import rasterize, rasterize_multi
from guidedvd3dgs_tpu_torch.train import guided as pg

from helpers import activated, make_camera, random_gaussians

torch.set_num_threads(2)

H, W = 48, 64
N = 300
NAMES = ("xyz", "scales", "rots", "opac", "sh_dc", "sh_rest", "offset")
CAMERAS = (
    dict(),
    dict(cam_z=-3.2, look_noise=0.35, seed=3),
    dict(cam_z=-4.6, look_noise=0.3, seed=5),
    dict(cam_z=9.0),  # every Gaussian behind it: an empty image
    dict(cam_z=-5.0, look_noise=0.5, seed=9),
)


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


def raw_gaussians():
    """300 raw Gaussians; the first 12 large, at the default camera's top
    and bottom image edges (y = -+2.19 at depth 4 with fov 1)."""
    xyz, log_s, rots, opac_logit, sh = random_gaussians(n=N, seed=11)
    rng = np.random.default_rng(12)
    xyz[:12, 0] = rng.uniform(-2.0, 2.0, 12)
    xyz[:12, 1] = np.repeat([-2.19, 2.19], 6) + rng.uniform(-0.15, 0.15, 12)
    xyz[:12, 2] = rng.uniform(-0.5, 0.5, 12)
    log_s[:12] = rng.uniform(-1.6, -1.0, (12, 3))
    opac_logit[:12] = 2.0
    return xyz, log_s, rots, opac_logit, sh


def cameras(b):
    return [make_camera(height=H, width=W, **kw) for kw in CAMERAS[:b]]


def loss_terms(colors, depths, alphas, targets):
    return sum(((c - t) ** 2).sum() + 0.1 * d.sum() + 0.05 * (a ** 2).sum()
               for c, d, a, t in zip(colors, depths, alphas, targets))


def targets(b):
    return np.random.default_rng(5).uniform(0, 1, (b, 3, H, W)).astype(np.float32)


def port_chain(parts, cams, b, bg):
    t = [torch.from_numpy(np.ascontiguousarray(p, np.float32)).requires_grad_(True) for p in parts[:4]]
    sh = np.ascontiguousarray(parts[4], np.float32)
    sh_dc = torch.from_numpy(sh[:, :1].copy()).requires_grad_(True)
    sh_rest = torch.from_numpy(sh[:, 1:].copy()).requires_grad_(True)
    off = torch.zeros((b, N, 2), requires_grad=True)
    out = rasterize_multi(*t, (sh_dc, sh_rest), [raster_camera_from_numpy(c.raster_camera()) for c in cams],
                          torch.from_numpy(bg), means2d_offset=off)
    loss_terms(out.color, out.depth, out.alpha, torch.from_numpy(targets(b))).backward()
    return out, [x.grad.numpy() for x in t + [sh_dc, sh_rest, off]]


def port_singles(parts, cams, b, bg):
    t = [torch.from_numpy(np.ascontiguousarray(p, np.float32)).requires_grad_(True) for p in parts[:4]]
    sh = np.ascontiguousarray(parts[4], np.float32)
    sh_dc = torch.from_numpy(sh[:, :1].copy()).requires_grad_(True)
    sh_rest = torch.from_numpy(sh[:, 1:].copy()).requires_grad_(True)
    offs = [torch.zeros((N, 2), requires_grad=True) for _ in range(b)]
    outs = [rasterize(*t, (sh_dc, sh_rest), raster_camera_from_numpy(c.raster_camera()),
                      torch.from_numpy(bg), means2d_offset=o) for c, o in zip(cams, offs)]
    loss_terms([o.color for o in outs], [o.depth for o in outs], [o.alpha for o in outs],
               torch.from_numpy(targets(b))).backward()
    grads = [x.grad.numpy() for x in t + [sh_dc, sh_rest]] + [np.stack([o.grad.numpy() for o in offs])]
    return outs, grads


def jax_chain(parts, cams, b, bg):
    jcams = stack_cameras([c.raster_camera() for c in cams])

    def loss(xyz, scales, rots, opac, sh, off):
        mo = jax_raster_tiles.rasterize_tiles_multi(xyz, scales, rots, opac, sh, jcams, jnp.asarray(bg),
                                                    means2d_offset=off, max_instances=1 << 16)
        return loss_terms(mo.color, mo.depth, mo.alpha, jnp.asarray(targets(b))), mo

    (_, mo), g = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, parts), jnp.zeros((b, N, 2)))
    assert int(mo.overflow) == 0
    sh = np.asarray(g[4])
    return mo, [np.asarray(x) for x in g[:4]] + [sh[:, :1], sh[:, 1:], np.asarray(g[5])]


@pytest.mark.parametrize("b", [2, 5])
def test_chain_matches_jax_chain(b):
    parts = [np.asarray(p, np.float32) for p in activated(*raw_gaussians())]
    cams = cameras(b)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    out, got = port_chain(parts, cams, b, bg)
    mo, ref = jax_chain(parts, cams, b, bg)
    assert out.color.shape == (b, 3, H, W) and out.depth.shape == out.alpha.shape == (b, H, W)
    np.testing.assert_allclose(out.color.detach().numpy(), np.asarray(mo.color), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.depth.detach().numpy(), np.asarray(mo.depth), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.alpha.detach().numpy(), np.asarray(mo.alpha), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(mo.radii))
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert np.isfinite(g).all(), name
        assert normalised_err(g, r) <= 2e-4, (name, normalised_err(g, r))
    # the edge Gaussians are in view, their rectangles cut at the band's edge
    assert (out.radii[:, :12] > 0).sum() >= 6
    if b == 5:  # the camera behind every Gaussian
        assert int(out.radii[3].sum()) == 0 and float(out.alpha[3].detach().abs().max()) == 0.0
        np.testing.assert_array_equal(out.color[3].detach().numpy(), np.broadcast_to(bg[:, None, None], (3, H, W)))
        assert float(np.abs(got[-1][3]).max()) == 0.0


@pytest.mark.parametrize("b", [2, 5])
def test_chain_matches_single_renders(b):
    parts = [np.asarray(p, np.float32) for p in activated(*raw_gaussians())]
    cams = cameras(b)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    out, got = port_chain(parts, cams, b, bg)
    singles, want = port_singles(parts, cams, b, bg)
    for c, s in enumerate(singles):
        assert torch.equal(out.color[c], s.color), c
        assert torch.equal(out.depth[c], s.depth), c
        assert torch.equal(out.alpha[c], s.alpha), c
        assert torch.equal(out.radii[c], s.radii), c
    assert out.num_instances == sum(s.num_instances for s in singles)
    np.testing.assert_array_equal(got[-1], want[-1])  # each camera's own K6 rows
    for name, g, w in zip(NAMES, got, want):
        assert normalised_err(g, w) <= 1e-5, (name, normalised_err(g, w))
    if b == 2:
        # the SH pair is summed over the cameras, not the last camera's alone
        _, last = port_singles(parts, cams[1:], 1, bg)
        for k in (4, 5):
            assert normalised_err(got[k], last[k]) > 1e-2, NAMES[k]


def test_frozen_render_many_matches_jax():
    raw = raw_gaussians()
    pts = raw[0]
    jstate = JG.create_from_pcd(pts, np.full((N, 3), 0.5, np.float32), capacity=512)
    p = jstate.params
    k = jstate.capacity
    pad = lambda a: np.concatenate([a, np.zeros((k - N,) + a.shape[1:], np.float32)])  # noqa: E731
    jparams = p._replace(xyz=jnp.asarray(pad(raw[0])), scaling=jnp.asarray(pad(raw[1])),
                         rotation=jnp.asarray(pad(raw[2])), opacity=jnp.asarray(pad(raw[3])),
                         features_dc=jnp.asarray(pad(raw[4][:, :1])),
                         features_rest=jnp.asarray(pad(raw[4][:, 1:])))
    jstate = jstate._replace(params=jparams)
    port_params = params_from_numpy(dict(xyz=raw[0], features_dc=raw[4][:, :1], features_rest=raw[4][:, 1:],
                                         scaling=raw[1], rotation=raw[2], opacity=raw[3]), "cpu")
    cams = [make_camera(height=H, width=W, cam_z=-4.0 - 0.15 * i, look_noise=0.2, seed=20 + i) for i in range(7)]
    w2cs = []
    for c in cams:
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = np.asarray(c.R).T, c.T
        w2cs.append(w2c)
    w2cs = np.stack(w2cs)
    fx = W / (2.0 * math.tan(cams[0].FoVx / 2.0))
    fy = H / (2.0 * math.tan(cams[0].FoVy / 2.0))
    K = np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1]])
    jr = jg.FrozenRenderer(jstate, sh_degree=3, backend="tiles")
    pr = pg.FrozenRenderer(port_params, 3, backend="tiles")
    want = [np.asarray(x) for x in jr.render_many(w2cs, K, H, W)]
    got = [x.numpy() for x in pr.render_many(w2cs, K, H, W)]
    for name, g, w, tol in zip(("color", "alpha", "depth"), got, want, (1e-5, 1e-5, 1e-4)):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
    assert float(got[1].max()) > 0.5  # the frames see the Gaussians
    # each frame is the single render of its camera (one chain per group)
    for i in (0, 4, 5, 6):
        one = pr.render(w2cs[i], K, H, W)
        for a, b in zip(one, (got[0][i], got[1][i], got[2][i])):
            np.testing.assert_array_equal(a.numpy(), b)


def test_chain_binning_bands():
    """The chain's binning of B = 3 cameras: a grid of 3 bands of gy_cam
    tile rows, each camera's rectangles its single render's moved into its
    band, and K3's plain version keying each instance to its single
    render's tile plus the band's first tile (the cull reads the row within
    the band)."""
    from guidedvd3dgs_tpu_torch.ops import expand, preprocess_fused, tiling

    parts = [torch.from_numpy(np.asarray(p, np.float32)) for p in activated(*raw_gaussians())]
    cams = [raster_camera_from_numpy(c.raster_camera()) for c in cameras(3)]
    tabs = [preprocess_fused.preprocess_fused_fwd(*parts, c, 3, 1.0, skip_unbinned=True) for c in cams]
    chain = torch.cat(tabs, 1)
    radii = preprocess_fused.visible_radii(chain)
    rmx, rmy, w, count, offsets, gx, num_tiles, total = tiling.expand_inputs(chain, radii, W, H, n_cams=3)
    gy_cam = (H + 15) // 16
    assert num_tiles == 3 * gx * gy_cam
    keys, owners, hist = expand.expand_instances_plain(chain, rmx, rmy, w, count, offsets, gx, num_tiles,
                                                       total, gy_cam)
    for c, tab in enumerate(tabs):
        s = tiling.expand_inputs(tab, preprocess_fused.visible_radii(tab), W, H)
        cols = slice(c * N, (c + 1) * N)
        assert torch.equal(rmx[cols], s[0]) and torch.equal(rmy[cols], s[1] + c * gy_cam)
        assert torch.equal(count[cols], s[3])
        k1, _, h1 = expand.expand_instances_plain(tab, *s)
        lo, hi = int(offsets[c * N]), int(offsets[c * N]) + s[-1]
        tile = keys[lo:hi] >> 32
        base = c * gx * gy_cam
        want = torch.where(k1 >> 32 == s[-2], torch.full_like(k1 >> 32, num_tiles), (k1 >> 32) + base)
        assert torch.equal(tile, want) and torch.equal(keys[lo:hi] & 0xFFFFFFFF, k1 & 0xFFFFFFFF)
        assert torch.equal(hist[base:base + gx * gy_cam], h1)
