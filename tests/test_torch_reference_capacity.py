"""The reference tool's ground-truth instance drop, as
scripts/synthetic_reference_gt.py reckons it, against the JAX package.

The tool-default synthetic scene (150,000 Gaussians, 624x352, seed 7) needs
more (Gaussian, tile) instances in test camera 15 than the reference's
default capacity holds; PERF.md cites these counts.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from guidedvd3dgs_tpu.ops import projection as jax_projection
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu_torch.convert import params_from_numpy
from guidedvd3dgs_tpu_torch.scene import synthetic

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
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
