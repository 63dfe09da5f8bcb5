"""The guided trainer's helpers, port against reference, on the CPU.

Exact equality throughout (the same f32 operations, or host numpy):
  - erode / dilate at sizes 3, 5 and 10 (an even window is off centre),
    unobserved_regions and process_mask, on random masks with set borders;
  - the point splat at 48x64 (camera space and world space), with planted
    depth ties that the lowest index must win: the winner masks, images
    and depths; visible_points_mask;
  - select_topk_candidates on areas with ties;
  - pose_math: every TRAJ_PRESETS trajectory, the candidate grid and the
    linear path, to 1e-10;
  - the ground-truth npz of the port's make_scene: the tool's keys, shapes,
    dtypes and values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.guidance import morphology as jax_morph
from guidedvd3dgs_tpu.guidance import pose_math as jax_pm
from guidedvd3dgs_tpu.ops import point_splat as jax_splat
from guidedvd3dgs_tpu.train.guided import select_topk_candidates as jax_select
from guidedvd3dgs_tpu_torch.guidance import morphology, pose_math
from guidedvd3dgs_tpu_torch.ops import point_splat
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train.guided import select_topk_candidates
from tools import make_synthetic_scene as tool

torch.set_num_threads(2)

H, W = 48, 64


def _masks(seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((3, H, W)) > 0.35).astype(np.float32)
    m[0, 0, :] = 1.0  # a full border row and column: the border erodes
    m[0, :, -1] = 1.0
    m[1, :, :] = 1.0  # all set: only the border erodes
    m[2, 10:20, 5:30] = 0.0  # a hole
    return m


@pytest.mark.parametrize("size", [3, 5, 10])
def test_erode_dilate_match_reference(size):
    for m in _masks(size):
        want_e = np.asarray(jax_morph.erode(jnp.asarray(m), size))
        want_d = np.asarray(jax_morph.dilate(jnp.asarray(m), size))
        np.testing.assert_array_equal(morphology.erode(torch.from_numpy(m), size).numpy(), want_e)
        np.testing.assert_array_equal(morphology.dilate(torch.from_numpy(m), size).numpy(), want_d)
    # bool input, batched
    mb = _masks(size) > 0.5
    np.testing.assert_array_equal(
        morphology.erode(torch.from_numpy(mb), size).numpy(),
        np.stack([np.asarray(jax_morph.erode(jnp.asarray(x), size)) for x in mb]))


def test_unobserved_regions_and_process_mask_match_reference():
    rng = np.random.default_rng(4)
    renders = rng.random((2, 3, H, W)).astype(np.float32)
    renders[:, :, 5:25, 10:40] = 0.0
    renders[1, :, 30:33, 0:3] = 0.0
    masks = (rng.random((2, 1, H, W)) > 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        morphology.unobserved_regions(torch.from_numpy(renders)).numpy(),
        np.asarray(jax_morph.unobserved_regions(jnp.asarray(renders))))
    np.testing.assert_array_equal(
        morphology.process_mask(torch.from_numpy(masks)).numpy(),
        np.asarray(jax_morph.process_mask(jnp.asarray(masks))))


def _cloud(seed, n=3000):
    """Camera-space points in front of a 48x64 camera, some behind it or
    outside the view, with planted exact depth ties at shared pixels."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(-0.5, 6.0, n)], 1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    # ties: later copies of earlier points (the same pixel and depth), so
    # the lower index must win; and one pair at the same depth one pixel apart
    pts[n - 200:] = pts[100:300]
    cols[n - 200:] = rng.uniform(size=(200, 3)).astype(np.float32)
    pts[n - 201] = pts[50] + np.array([0.01, 0.0, 0.0], np.float32)
    return pts, cols


@pytest.mark.parametrize("radius_ndc", [0.01, 0.1])
def test_point_splat_matches_reference(radius_ndc):
    pts, cols = _cloud(1)
    fx, fy, cx, cy = 40.0, 41.5, W / 2.0, H / 2.0
    mask = np.random.default_rng(2).random(pts.shape[0]) > 0.1
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    for point_mask, background in ((None, None), (mask, bg)):
        want = jax_splat.splat_points(
            jnp.asarray(pts), jnp.asarray(cols), fx, fy, cx, cy, H, W, radius_ndc=radius_ndc,
            background=None if background is None else jnp.asarray(background),
            point_mask=None if point_mask is None else jnp.asarray(point_mask))
        got = point_splat.splat_points(
            torch.from_numpy(pts), torch.from_numpy(cols), fx, fy, cx, cy, H, W, radius_ndc=radius_ndc,
            background=None if background is None else torch.from_numpy(background),
            point_mask=None if point_mask is None else torch.from_numpy(point_mask))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
        np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
        assert 0.2 < got.mask.float().mean() < 1.0


def _world_view(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=3) * 0.3
    c, s = np.cos(a), np.sin(a)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    w2c = np.eye(4)
    w2c[:3, :3] = ry @ rx
    w2c[:3, 3] = rng.normal(size=3) * 0.2
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    return w2c.astype(np.float32), K.astype(np.float32)


def test_point_splat_world_and_visible_mask_match_reference():
    pts, cols = _cloud(3)
    w2c, K = _world_view(5)
    want = jax_splat.splat_points_world(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(w2c),
                                        jnp.asarray(K), H, W)
    got = point_splat.splat_points_world(torch.from_numpy(pts), torch.from_numpy(cols),
                                         torch.from_numpy(w2c), torch.from_numpy(K), H, W)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    vis_want = np.asarray(jax_splat.visible_points_mask(jnp.asarray(pts), jnp.asarray(w2c),
                                                        jnp.asarray(K), H, W))
    vis = point_splat.visible_points_mask(torch.from_numpy(pts), torch.from_numpy(w2c),
                                          torch.from_numpy(K), H, W).numpy()
    np.testing.assert_array_equal(vis, vis_want)
    assert 0 < vis.sum() < vis.size


def test_topk_candidate_selection_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        # small integers: many ties, which index order breaks
        areas = rng.integers(0, 8, size=20).astype(np.float32) * 100.0
        thresh = float(rng.integers(100, 900))
        top_k = int(rng.integers(1, 4))
        np.testing.assert_array_equal(select_topk_candidates(areas, thresh, top_k),
                                      jax_select(areas, thresh, top_k))


def _obj_pose(seed):
    rng = np.random.default_rng(seed)
    c2w = np.eye(4)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    c2w[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    c2w[:3, 3] = rng.normal(size=3)
    return c2w.astype(np.float32)


@pytest.mark.parametrize("preset", sorted(pose_math.TRAJ_PRESETS))
def test_txt_preset_trajectories_match_reference(preset):
    assert pose_math.TRAJ_PRESETS[preset] == jax_pm.TRAJ_PRESETS[preset]
    c2w = _obj_pose(7)
    obj, back = pose_math.world_to_obj(c2w[None], -1, 1.7, 5.0)
    jobj, _, jback = jax_pm.world_to_obj(c2w[None], None, k=-1, r=1.7, elevation_deg=5.0)
    np.testing.assert_allclose(obj, jobj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(back, jback, rtol=0, atol=1e-10)
    got = back[None] @ pose_math.traj_from_txt(obj, *pose_math.TRAJ_PRESETS[preset], frames=25)
    want = jback[None] @ jax_pm.traj_from_txt(jobj, *jax_pm.TRAJ_PRESETS[preset], frames=25)
    assert got.shape == (25, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_candidate_grid_and_linear_path_match_reference():
    c2w = _obj_pose(9)
    obj, back = pose_math.world_to_obj(c2w[None], -1, 2.3, 5.0)
    d_phi, d_theta = [-30, -15, 0, 15, 30], [-15, -7.5, 0, 7.5]
    cands, offsets = pose_math.candidate_pose_grid(obj, back, d_phi, d_theta)
    jcands, joffsets = jax_pm.candidate_pose_grid(obj, back, d_phi, d_theta)
    assert offsets == joffsets
    np.testing.assert_allclose(cands, jcands, rtol=0, atol=1e-10)
    for ph, th, dr in offsets[::3]:
        np.testing.assert_allclose(pose_math.interpolate_trajectory(obj, ph, th, dr, frames=25),
                                   jax_pm.interpolate_trajectory(obj, ph, th, dr, frames=25),
                                   rtol=0, atol=1e-10)


def test_make_scene_writes_the_tools_gt_npz(tmp_path):
    n_gt, seed = 1200, 11
    synthetic.make_scene(str(tmp_path), height=16, width=24, n_gt=n_gt, n_init=100, n_cams=5,
                         n_train=2, seed=seed, device="cpu")
    got = np.load(tmp_path / "gt_gaussians.npz")
    rng = np.random.default_rng(seed)
    pts, cols = tool.sample_room(rng, n_gt)
    want = {k: np.asarray(v) for k, v in tool.build_gt_state(pts, cols, rng).items()}
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
