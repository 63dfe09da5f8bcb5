"""The append-pcd path (append_pcd_from_video_diffusion), port against the
JAX package and HuggingFace's DPT, on the CPU.

  - DPT at a toy width (hidden 32, 4 layers, 2 heads, neck (8, 16, 24, 32),
    fusion 16): the port against transformers' DPTForDepthEstimation on
    the same state dict within 1e-4 of the output's largest magnitude (the
    neck and head scaled up so that the output varies). The JAX package
    departs from HF in two places, pinned here: its transposed-convolution
    resizes swap the weight's in/out channels, and its stride-2 resize pads
    (0, 1) ("SAME") where HF pads (1, 1). The port follows HF; against JAX
    it is held with the JAX package given the same weights in its own
    layout (those resizes transposed and shifted) within 1e-5 of the
    largest magnitude. LayerNorm eps is 1e-12.
  - `midas_preprocess` (48x64 -> 48x64 and -> 96x128) and the estimator
    (frames at 40x56 run at 64x96: the depth shrunk back, antialiased)
    within 1e-5.
  - The four depth-lift functions: the same numpy code, equal to 1e-12.
  - `add_points`: the appended rows (features_dc the colour, identity
    rotation, opacity logit of 0.1, log-scale from the 3-NN distance)
    within 1e-6 of JAX's, zero moments, the statistics of every row zeroed.
  - One mock event with the append on both trainers (tests/
    test_torch_train_guided.py's scene, a shared closed-form depth
    estimator, SH degree 0): the same number of points added, every
    parameter within atol 2e-4 / rtol 1e-4 (the frozen depth's tolerance,
    through the scale-shift fit); then 6 guided steps, each trainer from
    its own appended state: equal counts, losses within 1e-4, every
    parameter within 1e-4 of the largest magnitude (that file's
    tolerances), xyz_gradient_accum within 1e-4 on the 96 rows that were
    there before the event and within 5e-4 on the appended rows, denom
    equal. The appended rows carry the event's difference into the steps:
    at seed 7, 2 of the 1249 appended rows' accum differ by more than
    1e-4 of the largest (2.8e-4 at most; 1.1% and 1.3% of their own
    values), rows whose positions differ by 8e-6 and 4e-5 after the event.
    A third trainer, the port's started from the reference's appended
    state, holds every row's accum to 1e-4.
The CLI's --dpt_weights and augment_ply_with_depth are in
tests/test_torch_append_pcd_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.guidance import depth_lift as JL
from guidedvd3dgs_tpu.guidance import dpt as JD
from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.guidance import depth_lift as TL
from guidedvd3dgs_tpu_torch.guidance import dpt as TD
from guidedvd3dgs_tpu_torch.models import gaussians as TG
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg

from helpers import activated, random_gaussians
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import GuidedOpt, _intrinsic

torch.set_num_threads(2)

TOY = dict(hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64, patch_size=16, pos_grid=4,
           out_indices=(0, 1, 2, 3), neck_hidden=(8, 16, 24, 32), reassemble_factors=(4.0, 2.0, 1.0, 0.5),
           fusion_hidden=16)


def toy_params(seed=0):
    """Toy DPT weights in HF's layout, the neck's and head's weights scaled
    by 6 and the last bias 2 so that the output varies (N(0, 0.02) leaves
    it constant to 1e-5), the stride-2 resize's first row and column zero
    (so that the JAX layout below can express it)."""
    p = TD.init_dpt_params(TD.DPTConfig(**TOY), seed)
    for k in p:
        if k.startswith(("neck.", "head.")) and k.endswith("weight"):
            p[k] = p[k] * 6.0
    p["head.head.4.bias"] = np.full((1,), 2.0, np.float32)
    w = p["neck.reassemble_stage.layers.3.resize.weight"]
    w[..., 0, :] = 0.0
    w[..., :, 0] = 0.0
    return p


def jax_layout(p):
    """The same network in the JAX package's layout: its transposed-conv
    resizes take the in/out-swapped weight, its stride-2 resize (padding
    (0, 1)) the kernel shifted up-left by one."""
    j = dict(p)
    for i, f in enumerate(TOY["reassemble_factors"]):
        k = f"neck.reassemble_stage.layers.{i}.resize.weight"
        if f > 1:
            j[k] = np.ascontiguousarray(p[k].transpose(1, 0, 2, 3))
        elif f < 1:
            wj = np.zeros_like(p[k])
            wj[..., :2, :2] = p[k][..., 1:, 1:]
            j[k] = wj
    return {k: jnp.asarray(v) for k, v in j.items()}


def _hf(p):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=64, image_size=64,
        patch_size=16, neck_hidden_sizes=[8, 16, 24, 32], fusion_hidden_size=16, is_hybrid=False,
        reassemble_factors=[4, 2, 1, 0.5], backbone_out_indices=[0, 1, 2, 3], readout_type="project",
        use_batch_norm_in_fusion_residual=False, add_projection=False, hidden_act="gelu")
    m = transformers.DPTForDepthEstimation(cfg).eval()
    sd = m.state_dict()
    missing = [k for k in sd if k not in p and not k.startswith("dpt.layernorm")]
    assert not missing, missing
    m.load_state_dict({k: torch.from_numpy(p[k]) if k in p else v for k, v in sd.items()})
    return m


def test_dpt_forward_matches_hf_and_jax():
    p = toy_params(1)
    tp = TD.params_to_device(p, "cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    got = TD.dpt_forward(tp, TD.DPTConfig(**TOY), torch.from_numpy(x)).numpy()
    with torch.no_grad():
        ref = _hf(p)(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2))).predicted_depth.numpy()
    scale = np.abs(ref).max()
    assert ref.std() > 0.01 * scale  # not a constant output
    assert np.abs(got - ref).max() <= 1e-4 * scale
    # the JAX package as it stands departs from HF on the same weights
    plain = np.asarray(JD.dpt_forward({k: jnp.asarray(v) for k, v in p.items()}, JD.DPTConfig(**TOY),
                                      jnp.asarray(x)))
    assert np.abs(plain - ref).max() > 1e-2 * scale
    # ...and computes the port's network in its own layout
    x2 = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    want = np.asarray(JD.dpt_forward(jax_layout(p), JD.DPTConfig(**TOY), jnp.asarray(x2)))
    got = TD.dpt_forward(tp, TD.DPTConfig(**TOY), torch.from_numpy(x2)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert TD.LN_EPS == 1e-12


def test_init_params_and_preprocess_match_jax():
    pj = JD.init_dpt_params(JD.DPTConfig(**TOY), 5)
    pt = TD.init_dpt_params(TD.DPTConfig(**TOY), 5)
    assert set(pj) == set(pt) and all(np.array_equal(pj[k], pt[k]) for k in pj)
    assert TD.DPTConfig().out_indices == (5, 11, 17, 23) and TD.DPTConfig().hidden_size == 1024
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1.2, 1.2, size=(3, 48, 64, 3)).astype(np.float32)
    for hw in ((48, 64), (96, 128)):
        want = np.asarray(JD.midas_preprocess(jnp.asarray(frames), *hw))
        got = TD.midas_preprocess(torch.from_numpy(frames), *hw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    # the estimator: 40x56 frames -> 64x96 -> depth shrunk back to 40x56
    p = toy_params(2)
    frames = rng.uniform(-1, 1, size=(2, 40, 56, 3)).astype(np.float32)
    want = np.asarray(JD.make_depth_estimator(jax_layout(p), JD.DPTConfig(**TOY), 64, 96)(jnp.asarray(frames)))
    got = TD.make_depth_estimator(TD.params_to_device(p, "cpu"), TD.DPTConfig(**TOY), 64, 96)(
        torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 40, 56)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_depth_lift_functions_match_jax():
    rng = np.random.default_rng(4)
    n, h, w = 3, 10, 12
    rel = rng.uniform(0.2, 1.0, (n, h, w))
    real = rng.uniform(1.0, 4.0, (n, h, w))
    mask = (rng.random((n, h, w)) > 0.4).astype(np.float32)
    sj, tj = JL.fit_scale_shift(rel, real, mask)
    st, tt = TL.fit_scale_shift(rel, real, mask)
    np.testing.assert_allclose(st, sj, rtol=1e-12)
    np.testing.assert_allclose(tt, tj, rtol=1e-12)
    np.testing.assert_allclose(TL.rel_to_metric(rel, st, tt), JL.rel_to_metric(rel, sj, tj), rtol=1e-12)
    K = np.array([[10.0, 0, 6], [0, 11.0, 5], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, 0.2, 0.3]
    rgb = rng.random((h, w, 3))
    for a, b in zip(TL.depth_to_point_cloud(real[0], K, c2w, mask[0], rgb),
                    JL.depth_to_point_cloud(real[0], K, c2w, mask[0], rgb)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    frames = rng.random((n, h, w, 3)).astype(np.float32)
    c2ws = np.stack([c2w] * n)
    rel[1, 0, 0] = np.nan  # a non-finite point is dropped
    for a, b in zip(TL.lift_video_to_points(frames, rel, real, mask, c2ws, K),
                    JL.lift_video_to_points(frames, rel, real, mask, c2ws, K)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12)


def _jstate(capacity=4096):
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=capacity)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jnp.asarray(scaling), rotation=jnp.asarray(rotation)))
    return jstate, pts, cols


def test_add_points_matches_jax():
    jstate, _, _ = _jstate(256)
    rng = np.random.default_rng(8)
    jstate = jstate._replace(xyz_gradient_accum=jnp.ones_like(jstate.xyz_gradient_accum),
                             denom=jnp.ones_like(jstate.denom), max_radii2d=jnp.ones_like(jstate.max_radii2d),
                             adam_m=jax.tree.map(lambda a: a + 0.5, jstate.adam_m))
    pstate = state_from_numpy(jax.device_get(jstate))
    new_pts = rng.normal(size=(40, 3)).astype(np.float32)
    new_rgb = rng.random((40, 3)).astype(np.float32)
    jout = jax.device_get(JG.add_points(jstate, new_pts, new_rgb))
    TG.add_points(pstate, new_pts, new_rgb)
    act = np.asarray(jout.active)
    assert pstate.num_gaussians == int(act.sum()) == 136
    for name in PARAM_NAMES:
        np.testing.assert_allclose(getattr(pstate.params, name).detach().numpy(),
                                   np.asarray(getattr(jout.params, name))[act], atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(pstate.adam_m[name].numpy(), np.asarray(getattr(jout.adam_m, name))[act])
        assert (pstate.adam_m[name][96:] == 0).all() and (pstate.adam_m[name][:96] == 0.5).all()
    for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert (getattr(pstate, name) == 0).all()
        np.testing.assert_array_equal(getattr(pstate, name).numpy(), np.asarray(getattr(jout, name))[act])
    np.testing.assert_allclose(pstate.params.get_opacity[96:].detach().numpy(), 0.1, rtol=1e-6)
    np.testing.assert_array_equal(pstate.params.rotation[96:].detach().numpy(),
                                  np.tile([1.0, 0, 0, 0], (40, 1)))


def _rel_depth(frames):
    """A closed-form relative inverse depth of frames in [-1, 1]."""
    return 0.5 + 0.25 * frames.mean(-1)


def test_mock_event_with_append_then_guided_steps_match_reference():
    cams = make_synthetic()
    jstate, pts, cols = _jstate()
    gt_parts = activated(*random_gaussians(n=80, seed=42))
    gt_state = JG.create_from_pcd(np.asarray(gt_parts[0]), np.ones((80, 3)) * 0.5, capacity=128)
    K = _intrinsic(cams[0])
    opt = GuidedOpt(start_sample_pseudo=0, densify_from_iter=1000, densify_until_iter=1000)
    opt.append_pcd_from_video_diffusion = True
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, opt, FakePipe(), FakeModelParams(sh_degree=0),
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K,
        depth_estimator=lambda f: _rel_depth(np.asarray(f)))
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]

    def port_trainer():
        return pg.GuidedTrainer(
            FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), opt,
            FakePipe(raster_backend="tiles"), FakeModelParams(sh_degree=0),
            frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
            engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
            pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K, depth_estimator=_rel_depth)

    pt, shared = port_trainer(), port_trainer()
    for t in (jt, pt, shared):
        t.init_trajectory_pool()
        t.run_diffusion_event(1)
    n_j = int(np.asarray(jt.state.active).sum())
    assert pt.points_added > 0 and pt.state.num_gaussians == n_j == 96 + pt.points_added
    assert pt.event_phase_s["lift"] > 0.0
    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for name in PARAM_NAMES:
        np.testing.assert_allclose(getattr(pt.state.params, name).detach().numpy(),
                                   np.asarray(getattr(jfinal.params, name))[act], atol=2e-4, rtol=1e-4)
    shared.state = state_from_numpy(jfinal)
    for it in range(2, 8):
        js, ps, ss = jt.step(it), pt.step(it), shared.step(it)
        assert ps.num_active == ss.num_active == js.num_active == n_j
        for loss in (ps.loss, ss.loss):
            assert abs(float(loss) - js.loss) <= 1e-4, (it, float(loss), js.loss)
    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for t, tol_new in ((pt, 5e-4), (shared, 1e-4)):
        for name in PARAM_NAMES:
            want = np.asarray(getattr(jfinal.params, name))[act]
            got = getattr(t.state.params, name).detach().numpy()
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (name, err)
        want = np.asarray(jfinal.xyz_gradient_accum)[act]
        err = np.abs(t.state.xyz_gradient_accum.numpy() - want) / np.abs(want).max()
        assert err[:96].max() <= 1e-4 and err[96:].max() <= tol_new, (err[:96].max(), err[96:].max())
        np.testing.assert_array_equal(t.state.denom.numpy(), np.asarray(jfinal.denom)[act])
