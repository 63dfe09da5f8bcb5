"""The ViewCrafter engine inside the guided trainer, port against the JAX
package on the CPU.

- One diffusion event of each package's trainer with its ViewCrafterEngine
  at the toy config of tests/test_torch_diffusion_models.py (T = 5, a 32x32
  engine fed by the 40x40 trainer of tests/test_torch_train_guided.py, 2
  guided DDIM steps), on the JAX package's random parameters carried across
  by `convert.diffusion_params_from_numpy`. The port is handed the noise of
  the key the JAX trainer splits for the event
  (test_torch_diffusion_slice.py::jax_request_noise). The pseudo stack's
  frames agree within 3e-4 absolute (the guided request's tolerance of
  tests/test_torch_guided_sampler.py); then 4 guided steps, each with a
  pseudo view: losses within 1e-4 and every parameter within 1e-4 of its
  largest magnitude, the tolerances of tests/test_torch_train_guided.py.
- The CLI's ViewCrafter branch with the loader stubbed: the engine width
  rule, the guidance_mean_loss refusal, recur_steps, recon_loss, the DDIM
  steps, the engine's settings from the options, the VGG term of the
  guidance only with weights, --guidance_tp refused and --pipeline_guidance
  accepted.
- A tiny checkpoint in the ViewCrafter layout (sub-model and CLIP
  prefixes, framestride_embed, Lightning's state_dict nesting, a buffer)
  loads through the CLI into an engine whose request equals the in-memory
  engine's, bit for bit.
"""

import argparse
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch import train_guidedvd as port_cli
from guidedvd3dgs_tpu_torch.config import OptimizationParams
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy, state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg

from test_torch_diffusion_models import T, toy_configs
from test_torch_diffusion_slice import ENGINE, jax_request_noise
from test_torch_train_guided import _np, _opt, _states
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import _intrinsic

torch.set_num_threads(2)

STEPS = range(2, 6)  # 4 guided steps after the event at iteration 1


@pytest.fixture(scope="module")
def toy():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    return jm, js, pm, ps, jparams, diffusion_params_from_numpy(jparams, device="cpu")


def test_a_viewcrafter_event_and_steps_match_reference(toy):
    jm, js, pm, ps, jparams, tparams = toy
    cams = make_synthetic()
    jstate, gt_state, pts, cols = _states()
    K = _intrinsic(cams[0])
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(), FakeModelParams(),
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.ViewCrafterEngine(jparams, jm, js, video_length=T, height=ENGINE, width=ENGINE,
                                    encoder_residency="resident"),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    engine = pg.ViewCrafterEngine(tparams, pm, ps, video_length=T, height=ENGINE, width=ENGINE)
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), FakeModelParams(),
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=engine, pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K)
    jt.init_trajectory_pool()
    pt.init_trajectory_pool()

    key = jax.random.split(jt.jrng)[1]  # the event's key (JAX train/guided.py:1370)
    jt.run_diffusion_event(1)
    engine.generate = functools.partial(engine.generate, noise=jax_request_noise(key, ps.ddim_steps))
    pt.run_diffusion_event(1)
    assert pt.events_run == jt.events_run == 1
    assert len(pt.pseudo_stack) == len(jt.pseudo_stack) == T - 1
    assert len(pt.pseudo_stack_alltime) == len(jt.pseudo_stack_alltime)
    for g, w in zip(pt.pseudo_stack, jt.pseudo_stack):
        np.testing.assert_array_equal(g.world_view_transform, w.world_view_transform)
        assert g.pseudo_gt.shape == (3, 40, 40) and g.pseudo_gt.dtype == torch.float32
        np.testing.assert_allclose(_np(g.pseudo_gt), _np(w.pseudo_gt), atol=3e-4, rtol=0)
        np.testing.assert_array_equal(_np(g.mask), _np(w.mask))

    for it in STEPS:
        js, ps_ = jt.step(it), pt.step(it)
        assert abs(float(ps_.loss) - js.loss) <= 1e-4, (it, float(ps_.loss), js.loss)
        jp, pp = float(jt.last_metrics["pseudo_l1"]), float(pt.last_metrics["pseudo_l1"])
        assert pp > 0.0 and abs(pp - jp) <= 1e-4, (it, pp, jp)
    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jfinal.params, name))[act]
        got = getattr(pt.state.params, name).detach().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)


def _toy_cli(monkeypatch, pm, ps):
    """The CLI's configs at the toy size."""
    monkeypatch.setattr(port_cli, "LatentDiffusionConfig", lambda: pm)
    monkeypatch.setattr(port_cli, "SynthesisConfig",
                        lambda ddim_steps: dataclasses.replace(ps, ddim_steps=ddim_steps))


ARGS = argparse.Namespace(viewcrafter_ckpt="vc.ckpt", oracle_gt_npz=None, oracle_backend="auto")


def test_cli_viewcrafter_branch(toy, monkeypatch, tmp_path):
    _, _, pm, ps, _, tparams = toy
    _toy_cli(monkeypatch, pm, ps)
    loads = []

    def stub(path, device="cpu", dtype=None):
        loads.append((path, torch.device(device), dtype))
        return dict(tparams._asdict(), buffers={})

    monkeypatch.setattr(port_cli, "load_viewcrafter_checkpoint", stub)
    cpu = torch.device("cpu")
    opt = OptimizationParams(guidance_recur_steps=2, guidance_recon_loss="l1", guidance_ddim_steps=3)
    eng = port_cli.build_engine(ARGS, opt, 480, 640, cpu)
    assert loads == [("vc.ckpt", cpu, torch.float32)]
    assert isinstance(eng, pg.ViewCrafterEngine) and eng.device == cpu
    assert (eng.video_length, eng.height, eng.width) == (25, 320, 448)
    assert eng.guided_cfg.recur_steps == 2 and eng.recon_loss == "l1" and eng.scfg.ddim_steps == 3
    assert eng.mcfg.compute_dtype == "float32"
    # the width rule: 448 within 0.2 of an aspect ratio of 1.4, else 512;
    # 512 under scannetpp_newres
    for h, w, newres, want in ((480, 640, False, 448), (480, 640, True, 512), (352, 624, False, 512),
                               (480, 480, False, 512), (420, 640, False, 448), (400, 640, False, 512)):
        assert port_cli.engine_width(OptimizationParams(scannetpp_newres=newres), h, w) == want, (h, w)
    assert port_cli.build_engine(ARGS, OptimizationParams(scannetpp_newres=True), 480, 640, cpu).width == 512
    with pytest.raises(ValueError, match="guidance_mean_loss"):
        port_cli.build_engine(ARGS, OptimizationParams(guidance_mean_loss=True), 480, 640, cpu)
    # the engine follows the trainer on the CPU, whatever guidance_gpu_id
    assert port_cli.guidance_device(OptimizationParams(guidance_gpu_id=1), cpu) == cpu

    # the guidance settings; the VGG term only with weights and guidance_with_lpips
    vgg = lambda x, y, mask=None, per_sample=False: (x - y).square().mean(dim=(1, 2, 3))
    set_opt = OptimizationParams(guidance_with_lpips=True, guidance_with_ssim=True, guidance_verbose=True,
                                 w_guidance_recon_loss=0.25, scale_guidance_weight=True)
    port_cli.configure_engine(eng, set_opt, None)
    assert eng.lpips_fn is None
    assert (eng.ssim_guidance, eng.verbose, eng.w_recon, eng.scale_weight_mode) == (True, True, 0.25, True)
    port_cli.configure_engine(eng, OptimizationParams(guidance_with_lpips=False), vgg)
    assert eng.lpips_fn is None and not eng.ssim_guidance and eng.w_recon == 0.5
    port_cli.configure_engine(eng, set_opt, vgg)
    d, g = torch.rand(3, 8, 8, 3), torch.rand(3, 8, 8, 3)
    got = eng.lpips_fn(d, g, torch.ones_like(d))
    assert got.shape == (3,)
    torch.testing.assert_close(got, torch.stack([vgg(d[i:i + 1].permute(0, 3, 1, 2),
                                                     g[i:i + 1].permute(0, 3, 1, 2))[0] for i in range(3)]))

    # the JAX package's tensor-parallel engine waits for a multi-card host;
    # pipelined events are accepted (the CLI goes on to read the scene,
    # which this directory lacks; tests/test_torch_pipeline_guidance.py runs them)
    argv = ["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--baseline_path", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="multi-card host"):
        port_cli.main(argv + ["--guidance_tp", "2"])
    with pytest.raises(ValueError, match="Could not recognize scene type"):
        port_cli.main(argv + ["--pipeline_guidance"])


def test_a_viewcrafter_layout_checkpoint_loads_into_the_engine(toy, monkeypatch, tmp_path):
    _, _, pm, ps, _, tparams = toy
    _toy_cli(monkeypatch, pm, ps)
    prefixes = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                "clip_text": "cond_stage_model.model.", "clip_image": "embedder.model.visual.",
                "resampler": "image_proj_model."}
    sd = {"scale_arr": torch.linspace(1.0, 0.7, 1000)}
    for part, prefix in prefixes.items():
        for k, v in getattr(tparams, part).items():
            sd[prefix + k.replace("fps_embedding", "framestride_embed")] = v
    assert any("framestride_embed" in k for k in sd)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 0}, path)
    args = argparse.Namespace(**dict(vars(ARGS), viewcrafter_ckpt=str(path)))
    eng = port_cli.build_engine(args, OptimizationParams(guidance_ddim_steps=ps.ddim_steps), 40, 40,
                                torch.device("cpu"))
    for part in prefixes:
        assert set(getattr(eng.params, part)) == set(getattr(tparams, part)), part
    eng.video_length, eng.height, eng.width = T, ENGINE, ENGINE
    ref = pg.ViewCrafterEngine(tparams, pm, ps, video_length=T, height=ENGINE, width=ENGINE)
    pc = torch.from_numpy(np.random.default_rng(2).uniform(size=(T, 40, 40, 3)).astype(np.float32))
    noise = jax_request_noise(jax.random.key(9), ps.ddim_steps)
    got, want = (e.generate(pc, no_guidance=True, noise=noise) for e in (eng, ref))
    assert got.shape == (T, 3, ENGINE, ENGINE) and math.isfinite(float(got.sum()))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
