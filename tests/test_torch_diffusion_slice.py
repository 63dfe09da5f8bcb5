"""The generation slice as a whole, port against the JAX package on the CPU.

`ViewCrafterEngine.generate(no_guidance=True)` at the toy config of
tests/test_viewcrafter_engine.py (T = 5, an engine of 32x32 fed 40x40
renders, 2 DDIM steps), on the JAX package's random parameters carried
across by `convert.diffusion_params_from_numpy`. The port is handed the
noise the JAX engine draws: the test repeats JAX's key splits
(synthesis.split_synthesis_rng, model.encode_video_frames, the x_T draw of
sample_from_conditioning and the per-step draw of samplers/ddim.py) with
`jax.random` and injects the arrays. Tolerance: 2e-4 absolute on frames in
[0, 1] (float32 throughout; other summation orders, amplified by the CFG
scale of 7.5 over two steps).

Also `load_viewcrafter_checkpoint` on a tiny saved state dict with the
checkpoint's quirks, against the JAX package's loader.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import convert as jconvert
from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.train.guided import ViewCrafterEngine as JaxEngine
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy
from guidedvd3dgs_tpu_torch.diffusion import convert
from guidedvd3dgs_tpu_torch.diffusion.synthesis import SynthesisNoise, image_guided_synthesis
from guidedvd3dgs_tpu_torch.train.guided import ViewCrafterEngine, resize_renders

from test_torch_diffusion_models import T, toy_configs

torch.set_num_threads(2)

ENGINE, TRAIN = 32, 40  # engine size, render (train) size
LATENT = ENGINE // 2  # the toy VAE downsamples once


def jax_request_noise(key, steps: int) -> SynthesisNoise:
    """The three draws the JAX engine makes from `key`, as the port's
    injected noise."""
    rest, ck, sk = jax.random.split(key, 3)  # split_synthesis_rng
    eps = np.concatenate([np.asarray(jax.random.normal(k, (1, LATENT, LATENT, 4), jnp.float32))
                          for k in jax.random.split(ck, T)])  # encode_video_frames
    _, nk = jax.random.split(rest)  # sample_from_conditioning's x_T
    x_t = np.array(jax.random.normal(nk, (1, T, LATENT, LATENT, 4), jnp.float32))
    step_noise = []
    for _ in range(steps):  # samplers/ddim.py: key, nk = split(key) per step
        sk, nk = jax.random.split(sk)
        step_noise.append(np.asarray(jax.random.normal(nk, x_t.shape, jnp.float32)))
    return SynthesisNoise(encode_eps=torch.from_numpy(eps), x_T=torch.from_numpy(x_t),
                          steps=torch.from_numpy(np.stack(step_noise)))


@pytest.fixture(scope="module")
def engines():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    jeng = JaxEngine(jparams, jm, js, video_length=T, height=ENGINE, width=ENGINE,
                     encoder_residency="resident")
    teng = ViewCrafterEngine(diffusion_params_from_numpy(jparams, device="cpu"), pm, ps,
                             video_length=T, height=ENGINE, width=ENGINE)
    return jeng, teng


def test_generate_no_guidance_matches_jax(engines):
    jeng, teng = engines
    pc = np.random.default_rng(7).uniform(size=(T, TRAIN, TRAIN, 3)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jeng.generate(jnp.asarray(pc), None, None, None, key, no_guidance=True))
    noise = jax_request_noise(key, teng.scfg.ddim_steps)
    got = teng.generate(torch.from_numpy(pc), no_guidance=True, noise=noise)
    assert got.shape == want.shape == (T, 3, ENGINE, ENGINE)
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_generate_draws_from_the_generator(engines):
    """Without injected noise the request draws from its generator: the
    same seed gives the same video, another seed another one."""
    _, teng = engines
    pc = torch.from_numpy(np.random.default_rng(8).uniform(size=(T, ENGINE, ENGINE, 3)).astype(np.float32))
    a, b, c = (teng.generate(pc, no_guidance=True, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3


def test_guided_paths_are_not_in_this_slice(engines):
    """The guided request runs through the engine (guidance at another
    size, no depths): frames of the engine's size in [0, 1]. The two-scale
    CFG runs too (tests/test_torch_multicond.py holds it to JAX): finite
    decoded frames of the same size."""
    _, teng = engines
    rng = np.random.default_rng(13)
    pc = torch.from_numpy(rng.uniform(size=(T, ENGINE, ENGINE, 3)).astype(np.float32))
    gi = torch.from_numpy(rng.uniform(size=(T, 3, TRAIN, TRAIN)).astype(np.float32))
    gm = torch.ones((T, 1, TRAIN, TRAIN))
    out = teng.generate(pc, gi, gm, None, generator=torch.Generator().manual_seed(0), no_guidance=False)
    assert out.shape == (T, 3, ENGINE, ENGINE) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    multi = dataclasses.replace(teng.scfg, multiple_cond_cfg=True)
    out = image_guided_synthesis(teng.params, teng.mcfg, multi, pc * 2.0 - 1.0,
                                 generator=torch.Generator().manual_seed(0))
    assert out.shape == (T, ENGINE, ENGINE, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("size", [(32, 32), (56, 48), (24, 60)])
def test_resize_renders_matches_jax_image_resize(size):
    """The engine's input resize against the reference's jax.image.resize
    bilinear (antialiased where it shrinks): down, up, and one axis each
    way, from 40x40; 1e-5 absolute on values in [0, 1]."""
    pc = np.random.default_rng(12).uniform(size=(2, TRAIN, TRAIN, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(pc), (2, *size, 3), "bilinear")
    got = resize_renders(torch.from_numpy(pc), *size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("nesting", ["lightning", "deepspeed", "flat"])
def test_load_viewcrafter_checkpoint(tmp_path, nesting):
    rng = np.random.default_rng(11)
    sd = {
        "model.diffusion_model.framestride_embed.0.weight": rng.standard_normal((8, 4)),
        "model.diffusion_model.input_blocks.0.0.bias": rng.standard_normal(8),
        "first_stage_model.encoder.conv_in.weight": rng.standard_normal((4, 3, 3, 3)),
        "cond_stage_model.model.ln_final.weight": rng.standard_normal(6),
        "embedder.model.visual.conv1.weight": rng.standard_normal((6, 3, 2, 2)),
        "image_proj_model.latents": rng.standard_normal((1, 4, 6)),
        "scale_arr": rng.standard_normal(10),
    }
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    sd["model.diffusion_model.step"] = torch.tensor(3)
    ckpt = {"lightning": {"state_dict": sd, "epoch": 1},
            "deepspeed": {"module": {"module." + k: v for k, v in sd.items()}},
            "flat": sd}[nesting]
    path = tmp_path / "model.ckpt"
    torch.save(ckpt, path)
    want = jconvert.load_viewcrafter_checkpoint(str(path))
    got = convert.load_viewcrafter_checkpoint(str(path), dtype=torch.bfloat16)
    assert sorted(got) == sorted(want)
    assert "fps_embedding.0.weight" in got["unet"]
    # the port also strips the open_clip prefixes that the towers read without
    assert sorted(got["clip_text"]) == ["ln_final.weight"]
    assert sorted(got["clip_image"]) == ["conv1.weight"]
    for part in want:
        inner = convert.CLIP_PREFIXES.get(part, "")
        assert sorted(got[part]) == sorted(k[len(inner):] for k in want[part]), part
        for k, v in want[part].items():
            t = got[part][k[len(inner):]]
            if part != "buffers" and t.is_floating_point():
                assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(t.float().numpy(), np.asarray(v, np.float32), rtol=2 ** -8)
