"""The two-scale CFG sampler (the reference's --multiple_cond_cfg), port
against the JAX package, on the CPU.

  - `multicond_model_output` on closed-form model outputs, with and
    without the rescale: within 1e-6.
  - `ddim_sample_multicond`, 3 steps of the ViewCrafter schedule on
    closed-form model outputs, with the step noise of JAX's key splits
    injected: within 1e-5 + 2e-4 relative (latents of magnitude ~5; the
    CFG scales of 7.5 and 2.5 amplify float32 rounding over 3 steps).
  - A toy request through `ViewCrafterEngine.generate` with
    `multiple_cond_cfg` (cfg_img 2.5; and cfg_img None, which takes
    cfg_scale) at tests/test_torch_diffusion_slice.py's toy config, JAX's
    noise injected: frames within that file's 2e-4. The request runs
    unguided even when guidance buffers are given, as the reference's
    multicond sampler does, and differs from the one-scale CFG request.
  - `sample_from_conditioning` refuses a guidance_fn with
    `multiple_cond_cfg`: the engine owns the choice to run such a request
    unguided.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.diffusion import schedules as JS
from guidedvd3dgs_tpu.diffusion.samplers import ddim_multicond as JM
from guidedvd3dgs_tpu.train.guided import ViewCrafterEngine as JaxEngine
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy
from guidedvd3dgs_tpu_torch.diffusion import schedules as TS
from guidedvd3dgs_tpu_torch.diffusion import synthesis as TSyn
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_multicond as TM
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine

from test_torch_diffusion_models import T, toy_configs
from test_torch_diffusion_slice import ENGINE, TRAIN, jax_request_noise

torch.set_num_threads(2)

SHAPE = (1, 3, 4, 4, 4)


def _fns(lib):
    """Three closed-form 'model outputs' of (x, t) in either library."""
    sin, cos = (jnp.sin, jnp.cos) if lib == "jax" else (torch.sin, torch.cos)

    def tb(t):
        return t.reshape(-1, 1, 1, 1, 1).astype(jnp.float32) if lib == "jax" else \
            t.reshape(-1, 1, 1, 1, 1).to(torch.float32)

    return (lambda x, t: 0.5 * sin(x) + 1e-3 * tb(t),
            lambda x, t: 0.3 * cos(x) - 2e-4 * tb(t),
            lambda x, t: 0.2 * x + 0.1 * sin(2 * x))


def test_multicond_model_output_matches_jax():
    x = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    t = np.array([501])
    for rescale in (0.0, 0.7):
        want = np.asarray(JM.multicond_model_output(*_fns("jax"), jnp.asarray(x), jnp.asarray(t), 7.5, 2.5, rescale))
        got = TM.multicond_model_output(*_fns("torch"), torch.from_numpy(x), torch.from_numpy(t), 7.5, 2.5,
                                        rescale).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_three_step_sampler_matches_jax():
    steps = 3
    x_t = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    key = jax.random.key(4)
    js = JS.make_schedule()
    want = np.asarray(JM.ddim_sample_multicond(js, JS.make_ddim_params(js, steps), *_fns("jax"), jnp.asarray(x_t),
                                               key, cfg_text=7.5, cfg_img=2.5, guidance_rescale=0.7))
    noise, k = [], key
    for _ in range(steps):  # the JAX sampler's per-step split
        k, nk = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(nk, SHAPE, jnp.float32)))
    ts = TS.make_schedule()
    got = TM.ddim_sample_multicond(ts, TS.make_ddim_params(ts, steps), *_fns("torch"), torch.from_numpy(x_t),
                                   noise=torch.from_numpy(np.stack(noise)), cfg_text=7.5, cfg_img=2.5,
                                   guidance_rescale=0.7).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=2e-4)


def test_multicond_request_matches_jax():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    tparams = diffusion_params_from_numpy(jparams, device="cpu")
    rng = np.random.default_rng(7)
    pc = rng.uniform(size=(T, TRAIN, TRAIN, 3)).astype(np.float32)
    gi = rng.uniform(size=(T, 3, TRAIN, TRAIN)).astype(np.float32)
    gm = np.ones((T, 1, TRAIN, TRAIN), np.float32)
    key = jax.random.key(3)
    noise = jax_request_noise(key, ps.ddim_steps)
    outs = {}
    for cfg_img in (2.5, None):
        jeng = JaxEngine(jparams, jm, dataclasses.replace(js, multiple_cond_cfg=True, cfg_img=cfg_img),
                         video_length=T, height=ENGINE, width=ENGINE, encoder_residency="resident")
        teng = ViewCrafterEngine(tparams, pm, dataclasses.replace(ps, multiple_cond_cfg=True, cfg_img=cfg_img),
                                 video_length=T, height=ENGINE, width=ENGINE)
        want = np.asarray(jeng.generate(jnp.asarray(pc), jnp.asarray(gi), jnp.asarray(gm), None, key,
                                        no_guidance=False))
        got = teng.generate(torch.from_numpy(pc), torch.from_numpy(gi), torch.from_numpy(gm), None,
                            no_guidance=False, noise=noise)
        assert got.shape == (T, 3, ENGINE, ENGINE) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
        outs[cfg_img] = got
    one_scale = ViewCrafterEngine(tparams, pm, ps, video_length=T, height=ENGINE, width=ENGINE).generate(
        torch.from_numpy(pc), no_guidance=True, noise=noise)
    assert float((outs[2.5] - one_scale).abs().max()) > 1e-3
    assert float((outs[2.5] - outs[None]).abs().max()) > 1e-3


def test_sample_from_conditioning_refuses_guidance_with_multicond():
    scfg = TSyn.SynthesisConfig(multiple_cond_cfg=True)
    with pytest.raises(ValueError, match="multiple_cond_cfg"):
        TSyn.sample_from_conditioning(None, None, scfg, None, None, guidance_fn=lambda *a: 0.0)
