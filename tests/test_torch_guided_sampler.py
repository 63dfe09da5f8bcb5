"""The guided DDIM sampler and the guided request, port against the JAX
package on the CPU.

At the toy config of tests/test_torch_diffusion_models.py on the JAX
package's random parameters (carried across by
`convert.diffusion_params_from_numpy`), with 32x32 latents (64x64
frames): the UNet's level-0 spatial attention and the VAE's mid-block
attention then see 1024 tokens, so L1's dispatch, its plain forward with
the log-sum-exp and its plain backward all lie on the tested path. The
port is handed the noise JAX draws (its key splits repeated with
jax.random). float32 throughout.

- one `guided_step` against JAX `_guided_step` (pair_mode "batched");
- `per_frame_guidance_grads` with decode_chunk 1, 2 and 3 (JAX pads the
  last chunk; the port decodes what is left);
- a frame with an empty mask: JAX gives NaN (0/0) that spreads over the
  whole step; the port gives that frame a zero gradient and agrees with
  JAX on the rest;
- `guided_ddim_sample` with recur_steps = 2 (the time-travel re-noise);
- a 2-step guided request through both engines (the toy config of
  tests/test_torch_diffusion_slice.py);
- the batched pair's batch check.

Tolerances (max abs error over max |value|): pred_x0 and the decode
gradients 1e-4 (float32 through the UNet, the VAE and its backward in
another summation order); x_prev 1e-4, the re-noised samples 2e-4; the
request's frames 3e-4 absolute on [0, 1] (two guided steps: rho divides
by the gradient's RMS, so rounding in the gradient is amplified), at a
guidance weight of 10, which moves the frames by ~7e-3 against the
unguided request.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.diffusion import model as jmodel
from guidedvd3dgs_tpu.diffusion import schedules as jS
from guidedvd3dgs_tpu.diffusion.samplers import ddim_guidance as jdg
from guidedvd3dgs_tpu.guidance import loss_guidance as jlg
from guidedvd3dgs_tpu.train.guided import ViewCrafterEngine as JaxEngine
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy
from guidedvd3dgs_tpu_torch.diffusion import model, schedules as S
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance as dg
from guidedvd3dgs_tpu_torch.guidance import loss_guidance as lg
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine

from test_torch_diffusion_models import CTX, T, toy_configs
from test_torch_diffusion_slice import ENGINE, TRAIN, jax_request_noise

torch.set_num_threads(2)

LATENT, IMAGE = 32, 64  # the toy VAE downsamples once
INDEX = 1  # the DDIM index of the single-step tests (of the toy's 2)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    tparams = diffusion_params_from_numpy(jparams, device="cpu")
    rng = np.random.default_rng(21)
    arrs = dict(
        context=rng.standard_normal((1, 8, CTX)).astype(np.float32),
        context_uc=rng.standard_normal((1, 8, CTX)).astype(np.float32),
        concat=rng.standard_normal((1, T, LATENT, LATENT, 4)).astype(np.float32),
        x=rng.standard_normal((1, T, LATENT, LATENT, 4)).astype(np.float32),
        images=rng.uniform(size=(T, 3, IMAGE, IMAGE)).astype(np.float32),
        masks=(rng.uniform(size=(T, 1, IMAGE, IMAGE)) > 0.3).astype(np.float32),
    )
    fs = np.full((1,), 10, np.int32)
    jcond = jmodel.Conditioning(jnp.asarray(arrs["context"]), jnp.asarray(arrs["concat"]), jnp.asarray(fs))
    juncond = jcond._replace(context=jnp.asarray(arrs["context_uc"]))
    tcond = model.Conditioning(torch.from_numpy(arrs["context"]), torch.from_numpy(arrs["concat"]),
                               torch.from_numpy(fs).long())
    tuncond = tcond._replace(context=torch.from_numpy(arrs["context_uc"]))
    jsched = jm.schedule()
    jpr = jS.make_ddim_params(jsched, js.ddim_steps, eta=js.ddim_eta, method=js.timestep_spacing)
    tsched = pm.schedule()
    tpr = S.make_ddim_params(tsched, ps.ddim_steps, eta=ps.ddim_eta, method=ps.timestep_spacing)
    return dict(jm=jm, pm=pm, jparams=jparams, tparams=tparams, arrs=arrs, jcond=jcond,
                juncond=juncond, tcond=tcond, tuncond=tuncond, jsched=jsched, jpr=jpr, tsched=tsched,
                tpr=tpr)


def guidance_pair(s, masks=None):
    """The JAX and the port's guidance functions on the same buffers."""
    images = s["arrs"]["images"]
    masks = s["arrs"]["masks"] if masks is None else masks
    jb = jlg.resize_guidance(jnp.asarray(images), IMAGE, IMAGE, masks=jnp.asarray(masks))
    tb = lg.resize_guidance(torch.from_numpy(images), IMAGE, IMAGE, masks=torch.from_numpy(masks))
    return jlg.make_guidance_fn(jb), lg.make_guidance_fn(tb)


def jax_step(s, jgf, scfg, x, key):
    return jdg._guided_step(s["jparams"], s["jm"], s["jsched"], s["jpr"], s["jcond"], s["juncond"],
                            scfg, jgf, jnp.float32(1.0), jnp.asarray(x), jnp.int32(INDEX), key)


def test_guided_step_matches_jax(setup, monkeypatch):
    s = setup
    jgf, tgf = guidance_pair(s)
    key = jax.random.key(5)
    jx, jp0, _ = jax_step(s, jgf, jdg.GuidedSampleConfig(pair_mode="batched", decode_chunk=2),
                          s["arrs"]["x"], key)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], jx.shape)))
    calls = {"fwd": 0, "bwd": 0}
    for name, tag in (("flash_attention_plain_lse", "fwd"), ("flash_attention_bwd_plain", "bwd")):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _t=tag: calls.__setitem__(_t, calls[_t] + 1) or _r(*a))
    scfg = dg.GuidedSampleConfig(decode_chunk=2)
    x_prev, p0, rho = dg.guided_step(s["tparams"], s["pm"], s["tsched"], s["tpr"], s["tcond"], s["tuncond"],
                                     scfg, tgf, 1.0, torch.from_numpy(s["arrs"]["x"]), INDEX, noise)
    # L1 under autograd: the 4 level-0 attentions of each branch run again
    # for the VJP (the batched pair runs first without autograd) and the
    # VAE mid attention of each of the 3 decode chunks; each backward once
    assert calls == {"fwd": 2 * 4 + 3, "bwd": 2 * 4 + 3}
    assert x_prev.shape == jx.shape and float(rho) > 0
    assert not x_prev.requires_grad and not p0.requires_grad
    assert rel(p0, jp0) <= 1e-4
    assert rel(x_prev, jx) <= 1e-4


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_per_frame_guidance_grads_match_jax(setup, chunk):
    s = setup
    jgf, tgf = guidance_pair(s)
    zs = np.random.default_rng(chunk).standard_normal((T, LATENT, LATENT, 4)).astype(np.float32)

    def floss(zf, frame_idx):
        return jgf(jmodel.decode_frame(s["jparams"], s["jm"], zf), INDEX, frame_idx)

    want = jdg._per_frame_guidance_grads(floss, jnp.asarray(zs), jdg.GuidedSampleConfig(decode_chunk=chunk))
    got = dg.per_frame_guidance_grads(s["tparams"], s["pm"], tgf, torch.from_numpy(zs), INDEX,
                                      dg.GuidedSampleConfig(decode_chunk=chunk))
    assert got.shape == (T, LATENT, LATENT, 4)
    assert rel(got, want) <= 1e-4


def test_empty_mask_frame(setup):
    """A guidance frame with no observed pixel: JAX's step is NaN
    everywhere (0/0 in that frame's gradient, spread by the UNet's VJP);
    the port zeroes that frame's gradient, agrees with JAX's gradient on
    the other frames and gives a finite step."""
    s = setup
    masks = s["arrs"]["masks"].copy()
    masks[1] = 0.0
    jgf, tgf = guidance_pair(s, masks)
    zs = np.random.default_rng(9).standard_normal((T, LATENT, LATENT, 4)).astype(np.float32)

    def floss(zf, frame_idx):
        return jgf(jmodel.decode_frame(s["jparams"], s["jm"], zf), INDEX, frame_idx)

    want = np.asarray(jdg._per_frame_guidance_grads(floss, jnp.asarray(zs), jdg.GuidedSampleConfig()))
    assert np.isnan(want[1]).all() and np.isfinite(np.delete(want, 1, axis=0)).all()
    got = dg.per_frame_guidance_grads(s["tparams"], s["pm"], tgf, torch.from_numpy(zs), INDEX,
                                      dg.GuidedSampleConfig(decode_chunk=2)).numpy()
    assert (got[1] == 0).all()
    keep = [f for f in range(T) if f != 1]
    assert rel(got[keep], want[keep]) <= 1e-4

    key = jax.random.key(6)
    jx, _, _ = jax_step(s, jgf, jdg.GuidedSampleConfig(pair_mode="batched"), s["arrs"]["x"], key)
    assert np.isnan(np.asarray(jx)).all()
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], jx.shape)))
    x_prev, _, rho = dg.guided_step(s["tparams"], s["pm"], s["tsched"], s["tpr"], s["tcond"], s["tuncond"],
                                    dg.GuidedSampleConfig(), tgf, 1.0, torch.from_numpy(s["arrs"]["x"]),
                                    INDEX, noise)
    assert bool(torch.isfinite(x_prev).all()) and float(rho) > 0


def test_recur_steps_matches_jax(setup):
    """One DDIM step with recur_steps = 2: two guided steps and the
    re-noise draw between them, in JAX's key order."""
    s = setup
    jgf, tgf = guidance_pair(s)
    jpr = jS.make_ddim_params(s["jsched"], 1)
    tpr = S.make_ddim_params(s["tsched"], 1)
    key = jax.random.key(8)
    want = jdg.guided_ddim_sample(s["jparams"], s["jm"], s["jsched"], jpr, s["jcond"], s["juncond"],
                                  jnp.asarray(s["arrs"]["x"]), key, jgf,
                                  jdg.GuidedSampleConfig(recur_steps=2, pair_mode="batched"))
    draws, k = [], key
    for _ in range(3):  # S * (2 recur_steps - 1)
        k, nk = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(nk, want.shape)))
    sample = functools.partial(dg.guided_ddim_sample, s["tparams"], s["pm"], s["tsched"], tpr, s["tcond"],
                               s["tuncond"], torch.from_numpy(s["arrs"]["x"]), tgf,
                               dg.GuidedSampleConfig(recur_steps=2))
    got = sample(noise=torch.from_numpy(np.stack(draws)))
    assert got.shape == want.shape
    assert rel(got, want) <= 2e-4
    with pytest.raises(ValueError, match="draws"):
        sample(noise=torch.from_numpy(np.stack(draws[:2])))


def test_guided_request_matches_jax():
    """`ViewCrafterEngine.generate(no_guidance=False)` of both packages at
    the slice test's toy config (T = 5, a 32x32 engine fed 40x40 renders
    and guidance, 2 DDIM steps)."""
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    jeng = JaxEngine(jparams, jm, js, video_length=T, height=ENGINE, width=ENGINE,
                     encoder_residency="resident")
    teng = ViewCrafterEngine(diffusion_params_from_numpy(jparams, device="cpu"), pm, ps,
                             video_length=T, height=ENGINE, width=ENGINE)
    rng = np.random.default_rng(17)
    pc = rng.uniform(size=(T, TRAIN, TRAIN, 3)).astype(np.float32)
    gi = rng.uniform(size=(T, 3, TRAIN, TRAIN)).astype(np.float32)
    gm = (rng.uniform(size=(T, 1, TRAIN, TRAIN)) > 0.2).astype(np.float32)
    gd = rng.uniform(1.0, 3.0, size=(T, 1, TRAIN, TRAIN)).astype(np.float32)
    key = jax.random.key(4)
    want = np.asarray(jeng.generate(*map(jnp.asarray, (pc, gi, gm, gd)), key, no_guidance=False,
                                    scale_guidance_weight=10.0))
    got = teng.generate(*map(torch.from_numpy, (pc, gi, gm, gd)), no_guidance=False,
                        scale_guidance_weight=10.0, noise=jax_request_noise(key, ps.ddim_steps))
    assert got.shape == want.shape == (T, 3, ENGINE, ENGINE)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=0)
    unguided = teng.generate(torch.from_numpy(pc), no_guidance=True,
                             noise=jax_request_noise(key, ps.ddim_steps))
    assert float((unguided - got).abs().max()) > 3e-3  # the guidance moved the frames


def test_pair_batch_is_checked(setup):
    """The batched pair splits the UNet's output at the latent batch, so
    both halves of the conditioning must match it."""
    s = setup
    _, tgf = guidance_pair(s)
    two = s["tuncond"]._replace(context=s["tuncond"].context.repeat(2, 1, 1))
    for cond, uncond in ((s["tcond"], two), (two, s["tuncond"])):
        with pytest.raises(ValueError, match="batch"):
            dg.guided_step(s["tparams"], s["pm"], s["tsched"], s["tpr"], cond, uncond, dg.GuidedSampleConfig(),
                           tgf, 1.0, torch.from_numpy(s["arrs"]["x"]), INDEX, torch.zeros(1, T, LATENT, LATENT, 4))
