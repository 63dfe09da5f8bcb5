"""The reference's instance drop, as scripts/synthetic_reference_gt.py and
scripts/guided_oracle_e2e.py reckon it, against the JAX package.

The tool-default synthetic scene (150,000 Gaussians, 624x352, seed 7) needs
more (Gaussian, tile) instances in test camera 15 than the reference's
default capacity holds; PERF.md cites these counts.

The oracle's emulation (`render_group_as_reference`) renders a group of
five frames as the reference's batched chain does at a capacity that ends
inside a Gaussian of the second frame (200 Gaussians, 64x48, capacity 512:
that Gaussian keeps 3 of its 4 tiles, the frames after it lose every
Gaussian): each frame within 5e-5 of the JAX package's
`rasterize_tiles_multi` at that capacity (interpret mode, exact fields,
the tile tolerance of tests/test_torch_raster.py), where dropping the
straddling Gaussian whole misses it by more. The JAX package's CLI
renders its oracle's frames one at a time (its --oracle_backend auto
takes the per-frame path of FrozenRenderer._render_many, each frame
`rasterize_tiles` at its default capacity max(4 N, 16384)), so the e2e
script emulates the oracle one frame a chain: that frame within 5e-5 of
JAX's `rasterize_tiles` at such a capacity.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from guidedvd3dgs_tpu.ops import projection as jax_projection
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.parallel.data_parallel import stack_cameras as jax_stack_cameras
from guidedvd3dgs_tpu_torch.convert import params_from_numpy
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train.guided import FrozenRenderer

from helpers import activated, make_camera, random_gaussians

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import guided_oracle_e2e as e2e  # noqa: E402
import synthetic_reference_gt as ref_gt  # noqa: E402

N_GT = 150_000


def test_capacity_is_the_reference_default():
    assert ref_gt.REFERENCE_QUANTUM == jax_tiling.QUANTUM
    assert ref_gt.reference_capacity(N_GT) == 600_064
    assert ref_gt.reference_capacity(100) == 1 << 14


def test_camera_15_drop_counts():
    rng = np.random.default_rng(7)
    pts, cols = synthetic.sample_room(rng, N_GT)
    gt = synthetic.gt_arrays(pts, cols, rng)
    _, cams = synthetic.orbit(ref_gt.N_CAMS, ref_gt.WIDTH, ref_gt.HEIGHT, ref_gt.FOV_DEG, rng)
    params = params_from_numpy(gt)
    rc = cams[15].raster_camera("cpu")
    count = ref_gt.tile_counts(params, rc, ref_gt.WIDTH, ref_gt.HEIGHT)

    # the same per-Gaussian tile counts as the reference's own preprocess and rects
    jcam = jax_projection.RasterCamera(
        jnp.asarray(rc.viewmatrix.numpy()), jnp.asarray(rc.projmatrix.numpy()),
        jnp.asarray(rc.campos.numpy()), rc.tanfovx, rc.tanfovy, rc.height, rc.width,
    )
    with torch.no_grad():
        acts = [jnp.asarray(t.numpy()) for t in (params.xyz, params.get_scaling, params.get_rotation,
                                                 params.get_opacity, params.get_features)]
    proc = jax_projection.preprocess_gaussians(*acts, jcam, 3)
    ref_count = np.asarray(jax_tiling.tile_rects(proc, ref_gt.WIDTH, ref_gt.HEIGHT)[4])
    np.testing.assert_array_equal(count.numpy(), ref_count)

    kept, dropped, slots = ref_gt.reference_drop(count, ref_gt.reference_capacity(N_GT))
    assert int(count.sum()) == 1_744_267
    assert slots == 1_884_103
    assert dropped == 1_242_078
    assert int((~kept).sum()) == 3_511


def _jax_camera(rc):
    return jax_projection.RasterCamera(
        jnp.asarray(rc.viewmatrix.numpy()), jnp.asarray(rc.projmatrix.numpy()),
        jnp.asarray(rc.campos.numpy()), rc.tanfovx, rc.tanfovy, rc.height, rc.width,
    )


def test_the_oracle_chain_keeps_the_straddling_gaussians_first_slots():
    h, w, capacity = 48, 64, 512
    raw = random_gaussians(n=200, seed=2, spread=1.0)
    xyz, ls, rots, opl, sh = raw
    params = params_from_numpy(dict(xyz=xyz, features_dc=sh[:, :1], features_rest=sh[:, 1:], scaling=ls,
                                    rotation=rots, opacity=opl), "cpu")
    cams = []
    for i in range(e2e.GROUP):
        c = make_camera(height=h, width=w, look_noise=0.3, seed=i)
        cams.append(port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy,
                                        image=np.zeros((3, h, w), np.float32)))
    w2cs = np.stack([np.asarray(c.world_view_transform).T for c in cams])
    fx = w / (2 * np.tan(cams[0].FoVx / 2))
    fy = h / (2 * np.tan(cams[0].FoVy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
    renderer = FrozenRenderer(params, 3, backend="tiles")
    frames, dropped = e2e.render_group_as_reference(renderer, w2cs, K, h, w, capacity, ref_gt)

    # the reference's chain at that capacity
    rcs = [pc.raster_camera("cpu") for pc in
           (port_cameras.camera_from_w2c_K(m, K, h, w) for m in w2cs)]
    counts = torch.cat([ref_gt.tile_counts(params, rc, w, h) for rc in rcs]).long()
    end = torch.cumsum(counts.clamp(min=1), 0)
    g = int(torch.nonzero((end - counts.clamp(min=1) < capacity) & (end > capacity)).flatten()[0])
    kept_slots = capacity - int(end[g] - counts[g])
    assert g // 200 == 1 and int(counts[g]) == 4 and kept_slots == 3
    assert dropped == int(counts.sum()) - int(counts[:g].sum()) - kept_slots
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    jax_raster_tiles.set_pack_grads(False)
    try:
        acts = [jnp.asarray(a) for a in activated(*raw)]
        want = jax_raster_tiles.rasterize_tiles_multi(
            *acts, jax_stack_cameras([_jax_camera(rc) for rc in rcs]), jnp.zeros(3), 3,
            max_instances=capacity)
    finally:
        jax_raster_tiles.set_interpret(prev)
        jax_tiling.set_pack_fields(True)
        jax_raster_tiles.set_pack_grads(True)
    want = np.asarray(want.color)
    assert int(np.asarray(want.shape[0])) == e2e.GROUP
    for j, got in enumerate(frames):
        np.testing.assert_allclose(got.detach().numpy(), want[j], atol=5e-5, rtol=0, err_msg=f"frame {j}")
    # the straddler matters: dropped whole, frame 1 misses the chain's
    keep = torch.ones(200, dtype=torch.bool)
    keep[g - 200:] = False
    whole = FrozenRenderer(type(params)(**{k: v[keep] for k, v in params.tensors().items()}), 3,
                           backend="tiles").render(w2cs[1], K, h, w)[0]
    assert float(np.abs(whole.numpy() - want[1]).max()) > 1e-3


def test_the_cli_oracle_renders_frame_by_frame_at_the_default_capacity(monkeypatch):
    """JAX's OracleDiffusionEngine as its CLI builds it (backend "auto"),
    above the dense backend's limit: tracing its render_many of 7 frames
    calls the single-camera rasterize_tiles at the default capacity, never
    the B-camera chain."""
    from guidedvd3dgs_tpu.ops import raster as jax_raster
    from guidedvd3dgs_tpu.train import guided as jg

    n = jax_raster._AUTO_DENSE_MAX + 904
    calls = []
    single, multi = jax_raster_tiles.rasterize_tiles, jax_raster_tiles.rasterize_tiles_multi

    def spy(name, fn):
        def wrapped(means3d, *args, **kwargs):
            calls.append((name, means3d.shape[0], kwargs.get("max_instances", 0)))
            return fn(means3d, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_raster_tiles, "rasterize_tiles", spy("single", single))
    monkeypatch.setattr(jax_raster_tiles, "rasterize_tiles_multi", spy("multi", multi))
    xyz, ls, rots, opl, sh = random_gaussians(n=n, seed=4)
    path = Path(__file__).resolve().parents[1] / "build" / "oracle_path_test.npz"
    path.parent.mkdir(exist_ok=True)
    np.savez(path, xyz=xyz, f_dc=sh[:, :1], f_rest=sh[:, 1:], scaling=ls, rotation=rots, opacity=opl)
    try:
        oracle = jg.OracleDiffusionEngine(str(path), video_length=7, height=48, width=64, backend="auto")
    finally:
        path.unlink()
    h, w = 48, 64
    rcs = [make_camera(height=h, width=w, look_noise=0.3, seed=i).raster_camera() for i in range(7)]
    stacked = jax_stack_cameras(rcs)
    r = oracle.renderer
    jax.eval_shape(lambda *a: r._render_many(r.state, *a, height=h, width=w), stacked.viewmatrix,
                   stacked.projmatrix, stacked.campos, rcs[0].tanfovx, rcs[0].tanfovy)
    assert calls and all(c == ("single", n, 0) for c in calls), calls
    # max_instances 0: rasterize_tiles' default, max(4 N, 16384) rounded up to its quantum
    assert ref_gt.reference_capacity(n) == e2e.chain_capacity(n, e2e.ORACLE_GROUP)


def test_one_frame_emulation_matches_the_reference_render_at_capacity():
    h, w, capacity = 48, 64, 512
    raw = random_gaussians(n=400, seed=2, spread=1.0, scale_lo=-3.5, scale_hi=-2.0)
    xyz, ls, rots, opl, sh = raw
    params = params_from_numpy(dict(xyz=xyz, features_dc=sh[:, :1], features_rest=sh[:, 1:], scaling=ls,
                                    rotation=rots, opacity=opl), "cpu")
    c = make_camera(height=h, width=w, look_noise=0.3, seed=1)
    cam = port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy,
                              image=np.zeros((3, h, w), np.float32))
    w2c = np.asarray(cam.world_view_transform).T
    fx = w / (2 * np.tan(cam.FoVx / 2))
    fy = h / (2 * np.tan(cam.FoVy / 2))
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
    rc = port_cameras.camera_from_w2c_K(w2c, K, h, w).raster_camera("cpu")
    count = ref_gt.tile_counts(params, rc, w, h)
    assert int(count.clamp(min=1).sum()) > capacity  # the frame overflows
    (frame,), dropped = e2e.render_group_as_reference(FrozenRenderer(params, 3, backend="tiles"), w2c[None], K,
                                                      h, w, capacity, ref_gt)
    assert dropped > 0
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    jax_raster_tiles.set_pack_grads(False)
    try:
        acts = [jnp.asarray(a) for a in activated(*raw)]
        want = jax_raster_tiles.rasterize_tiles(*acts, _jax_camera(rc), jnp.zeros(3), 3, max_instances=capacity)
    finally:
        jax_raster_tiles.set_interpret(prev)
        jax_tiling.set_pack_fields(True)
        jax_raster_tiles.set_pack_grads(True)
    assert int(want.overflow) == int(count.clamp(min=1).sum()) - capacity  # slots past it, empty ones too
    np.testing.assert_allclose(frame.detach().numpy(), np.asarray(want.color), atol=5e-5, rtol=0)
