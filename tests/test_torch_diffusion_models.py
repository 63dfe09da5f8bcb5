"""The diffusion models, port against the JAX package on the CPU, at toy
widths with the JAX package's random parameters carried across by
`convert.diffusion_params_from_numpy`.

Tolerances (max abs error over max |output| unless stated): float32 UNet,
VAE, CLIP towers and resampler 1e-4 (tens of layers of f32 products summed
in another order); the bf16 UNet held to the float32 result within 1.5x
the JAX package's own bf16 error (bf16 rounds at other places in each
package, through 20+ layers); the bf16 model glue 5e-2; image_preprocess 1e-4 absolute (the
antialiased bicubic resize of each library); schedules 1e-6 relative
(the same float64 numpy tables); the DDIM step 1e-5 absolute, q_sample
1e-6 absolute; the relative-position attention 1e-5 and the UNet with it
1e-4 (float32, as above).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import clip as jclip
from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.diffusion import model as jmodel
from guidedvd3dgs_tpu.diffusion import resampler as jres
from guidedvd3dgs_tpu.diffusion import schedules as jS
from guidedvd3dgs_tpu.diffusion import synthesis as jsyn
from guidedvd3dgs_tpu.diffusion import tokenizer as jtok
from guidedvd3dgs_tpu.diffusion import unet3d as junet
from guidedvd3dgs_tpu.diffusion import vae as jvae
from guidedvd3dgs_tpu.diffusion.samplers import ddim as jddim
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy
from guidedvd3dgs_tpu_torch.diffusion import clip, init, model, resampler, schedules as S, synthesis
from guidedvd3dgs_tpu_torch.diffusion import tokenizer, unet3d, vae
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim

torch.set_num_threads(2)

CTX, EMB, T = 32, 48, 5


def port_cfg(cls, jcfg):
    """The port's config dataclass with the JAX one's values (the port
    drops JAX-only fields such as remat)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def toy_configs():
    """The toy config of tests/test_viewcrafter_engine.py, in both packages:
    (jax mcfg, jax scfg, port mcfg, port scfg)."""
    jm = jmodel.LatentDiffusionConfig(
        unet=junet.UNetConfig(model_channels=32, num_res_blocks=1, attention_resolutions=(1,),
                              channel_mult=(1,), num_head_channels=8, context_dim=CTX,
                              temporal_length=T),
        vae=jvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                           resolution=32, z_channels=4),
    )
    js = jsyn.SynthesisConfig(
        ddim_steps=2,
        text_config=jclip.TextConfig(width=CTX, heads=4, layers=2),
        vision_config=jclip.VisionConfig(width=EMB, heads=4, layers=2, patch_size=32, image_size=224),
        resampler_config=jres.ResamplerConfig(dim=CTX, depth=1, dim_head=8, heads=4, num_queries=4,
                                              embedding_dim=EMB, output_dim=CTX, video_length=T),
    )
    pm = model.LatentDiffusionConfig(unet=port_cfg(unet3d.UNetConfig, jm.unet),
                                     vae=port_cfg(vae.VAEConfig, jm.vae))
    ps = synthesis.SynthesisConfig(
        ddim_steps=2, text_config=port_cfg(clip.TextConfig, js.text_config),
        vision_config=port_cfg(clip.VisionConfig, js.vision_config),
        resampler_config=port_cfg(resampler.ResamplerConfig, js.resampler_config))
    return jm, js, pm, ps


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def unet_cfg(attention_resolutions=(1, 2), channel_mult=(1, 2)):
    return junet.UNetConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=attention_resolutions, channel_mult=channel_mult,
                            num_head_channels=8, context_dim=16, temporal_length=T,
                            image_tokens_per_frame=4, text_context_len=7)


@pytest.fixture(scope="module")
def unet_case():
    jcfg = unet_cfg()
    jp = jinit.init_unet_params(jcfg, jax.random.key(1))
    return jcfg, jp, {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("ctx_tokens", [7 + T * 4, 7 + 12])
def test_unet_f32_both_context_branches(unet_case, ctx_tokens):
    """77 + T*16 tokens splits the image tokens per frame (reference
    unet3d.py:247-252); any other count repeats the context (:253-254),
    which is the guidedvd config's 77 + 256."""
    jcfg, jp, tp = unet_case
    rng = np.random.default_rng(ctx_tokens)
    x = rng.standard_normal((1, T, 8, 8, 8)).astype(np.float32)
    ts = np.array([421], np.int32)
    ctx = rng.standard_normal((1, ctx_tokens, 16)).astype(np.float32)
    fs = np.array([10], np.int32)
    want = junet.unet_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(fs))
    got = unet3d.unet_apply(tp, port_cfg(unet3d.UNetConfig, jcfg), torch.from_numpy(x),
                            torch.from_numpy(ts), torch.from_numpy(ctx), torch.from_numpy(fs))
    assert got.shape == (1, T, 8, 8, 4)
    assert rel_err(got, want) < 1e-4


def test_unet_bf16(unet_case):
    """bf16 rounds at other places in each package, so the two bf16 runs
    are held to the float32 result rather than to each other: the port's
    bf16 error is at most 1.5x the JAX package's bf16 error (both about 7%
    of max |output| with these random weights)."""
    jcfg, jp, tp = unet_case
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, T, 8, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 7 + 12, 16)).astype(np.float32)
    ts = np.array([900], np.int32)
    truth = junet.unet_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    want = junet.unet_apply(jp, jcfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(ts),
                            jnp.asarray(ctx, jnp.bfloat16))
    got = unet3d.unet_apply(tp, port_cfg(unet3d.UNetConfig, jcfg), torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(ts), torch.from_numpy(ctx).bfloat16())
    assert got.dtype == torch.bfloat16
    jax_err = rel_err(torch.from_numpy(np.asarray(want, np.float32)), truth)
    assert rel_err(got, truth) <= 1.5 * jax_err


def with_relative_tables(jp: dict, max_rel: int, dim_head: int, seed: int = 11) -> dict:
    """jp with the relative_position_{k,v}.embeddings_table entries of
    every attention (JAX's init makes none; the spatial ones' go unread):
    (2 max_rel + 1, dim_head)."""
    rng = np.random.default_rng(seed)
    out = dict(jp)
    for name in jp:
        if name.endswith(".to_q.weight"):
            pre = name[: -len(".to_q.weight")]
            for kv in "kv":
                out[f"{pre}.relative_position_{kv}.embeddings_table"] = rng.normal(
                    scale=0.3, size=(2 * max_rel + 1, dim_head)).astype(np.float32)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_with_relative_position(masked):
    """The relative-position bias on the logits and its term on the output
    (reference attention.py:100-127), with and without the causal mask; the
    distance clipped at temporal_length (3 here, of 6 tokens)."""
    from guidedvd3dgs_tpu.diffusion import attention as jattn
    from guidedvd3dgs_tpu_torch.diffusion import attention as pattn

    rng = np.random.default_rng(12)
    heads, dh, c, n, max_rel = 2, 8, 16, 6, 3
    p = {f"a.{nm}.weight": rng.normal(scale=0.3, size=(heads * dh, c)).astype(np.float32)
         for nm in ("to_q", "to_k", "to_v")}
    p["a.to_out.0.weight"] = rng.normal(scale=0.3, size=(c, heads * dh)).astype(np.float32)
    p["a.to_out.0.bias"] = rng.normal(scale=0.1, size=(c,)).astype(np.float32)
    p = with_relative_tables(p, max_rel, dh)
    x = rng.standard_normal((3, n, c)).astype(np.float32)
    mask = np.broadcast_to(np.tril(np.ones((n, n), np.float32)), (3, n, n)) if masked else None
    want = jattn.cross_attention({k: jnp.asarray(v) for k, v in p.items()}, "a", jnp.asarray(x), None, heads, dh,
                                 mask=None if mask is None else jnp.asarray(mask), relative_position=True,
                                 temporal_length=max_rel)
    got = pattn.cross_attention({k: torch.from_numpy(v) for k, v in p.items()}, "a", torch.from_numpy(x), None,
                                heads, dh, mask=None if mask is None else torch.from_numpy(mask.copy()),
                                relative_position=True, temporal_length=max_rel)
    assert rel_err(got, want) < 1e-5
    plain = pattn.cross_attention({k: torch.from_numpy(v) for k, v in p.items()}, "a", torch.from_numpy(x), None,
                                  heads, dh)
    assert rel_err(plain, want) > 1e-2  # the tables change the output


def test_unet_with_relative_position(unet_case):
    """unet_apply with use_relative_position: every temporal transformer
    (and init_attn) takes the tables, the spatial ones do not."""
    jcfg, jp, _ = unet_case
    jcfg = dataclasses.replace(jcfg, use_relative_position=True)
    jp = with_relative_tables({k: np.asarray(v) for k, v in jp.items()}, T, jcfg.num_head_channels)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, T, 8, 8, 8)).astype(np.float32)
    ts = np.array([421], np.int32)
    ctx = rng.standard_normal((1, 7 + 12, 16)).astype(np.float32)
    want = junet.unet_apply({k: jnp.asarray(v) for k, v in jp.items()}, jcfg, jnp.asarray(x), jnp.asarray(ts),
                            jnp.asarray(ctx))
    got = unet3d.unet_apply({k: torch.from_numpy(v) for k, v in jp.items()}, port_cfg(unet3d.UNetConfig, jcfg),
                            torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    assert got.shape == (1, T, 8, 8, 4)
    assert rel_err(got, want) < 1e-4


@pytest.fixture(scope="module")
def vae_case():
    jcfg = jvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                          resolution=64, z_channels=4)
    jp = jinit.init_vae_params(jcfg, jax.random.key(2))
    return jcfg, jp, {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}


def test_vae_encode_with_injected_eps(vae_case, monkeypatch):
    """A 64x64 image gives a 32x32 latent: 1024 tokens, so the mid-block
    attention takes the L1 dispatch (its plain version on the CPU)."""
    from guidedvd3dgs_tpu_torch.diffusion import nnops

    calls = []
    real = nnops.flash_attention
    monkeypatch.setattr(nnops, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    jcfg, jp, tp = vae_case
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    key = jax.random.key(5)
    want = jvae.vae_encode(jp, jcfg, jnp.asarray(x), rng=key)
    # the same eps the JAX function draws
    eps = np.array(jax.random.normal(key, want.shape, jnp.float32))
    got = vae.vae_encode(tp, port_cfg(vae.VAEConfig, jcfg), torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert got.shape == (2, 32, 32, 4)
    assert calls == [(2, 1, 1024, 64)]
    assert rel_err(got, want) < 1e-4


def test_vae_decode(vae_case):
    jcfg, jp, tp = vae_case
    z = np.random.default_rng(4).standard_normal((2, 32, 32, 4)).astype(np.float32)
    want = jvae.vae_decode(jp, jcfg, jnp.asarray(z))
    got = vae.vae_decode(tp, port_cfg(vae.VAEConfig, jcfg), torch.from_numpy(z))
    assert got.shape == (2, 64, 64, 3)
    assert rel_err(got, want) < 1e-4


def test_model_glue_apply_encode_decode():
    """apply_model in a bf16 compute dtype returns the input's dtype;
    decode_frame runs in the compute dtype; the encode at the frames'."""
    jm, js, pm, ps = toy_configs()
    jm = dataclasses.replace(jm, compute_dtype="bfloat16")
    pm = dataclasses.replace(pm, compute_dtype="bfloat16")
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    tparams = diffusion_params_from_numpy(jparams)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, T, 16, 16, 4)).astype(np.float32)
    concat = rng.standard_normal((1, T, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77 + 16, CTX)).astype(np.float32)
    ts = np.array([500], np.int32)
    fs = np.array([10], np.int32)
    jc = jmodel.Conditioning(context=jnp.asarray(ctx), concat=jnp.asarray(concat), fs=jnp.asarray(fs))
    tc = model.Conditioning(context=torch.from_numpy(ctx), concat=torch.from_numpy(concat),
                            fs=torch.from_numpy(fs))
    want = jmodel.apply_model(jparams, jm, jnp.asarray(x), jnp.asarray(ts), jc)
    got = model.apply_model(tparams, pm, torch.from_numpy(x), torch.from_numpy(ts), tc)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < 5e-2
    z = concat[0, 0]
    want = jmodel.decode_frame(jparams, jm, jnp.asarray(z))
    got = model.decode_frame(tparams, pm, torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (32, 32, 3)
    assert rel_err(got, want) < 5e-2


def test_clip_towers_and_preprocess():
    _, js, _, ps = toy_configs()
    key = jax.random.key(7)
    jt = jinit.init_clip_text_params(js.text_config, key)
    ji = jinit.init_clip_image_params(js.vision_config, key)
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in jt.items()}
    ti = {k: torch.from_numpy(np.asarray(v)) for k, v in ji.items()}
    toks = jtok.tokenize(["Rotating view of a scene", ""])
    want = jclip.text_encode(jt, js.text_config, jnp.asarray(toks))
    got = clip.text_encode(tt, ps.text_config, torch.from_numpy(toks).long())
    assert got.shape == (2, 77, CTX)
    assert rel_err(got, want) < 1e-4

    img = np.random.default_rng(8).uniform(-1, 1, (1, 320, 448, 3)).astype(np.float32)
    got_pre = clip.image_preprocess(torch.from_numpy(img))
    want_pre = jclip.image_preprocess(jnp.asarray(img))
    assert got_pre.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), atol=1e-4, rtol=0)
    want = jclip.image_encode(ji, js.vision_config, jnp.asarray(img))
    got = clip.image_encode(ti, ps.vision_config, torch.from_numpy(img))
    assert got.shape == (1, 1 + 7 * 7, EMB)
    assert rel_err(got, want) < 1e-4


def test_resampler():
    _, js, _, ps = toy_configs()
    jp = jinit.init_resampler_params(js.resampler_config, jax.random.key(8))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(9).standard_normal((2, 50, EMB)).astype(np.float32)
    want = jres.resampler_apply(jp, js.resampler_config, jnp.asarray(x))
    got = resampler.resampler_apply(tp, ps.resampler_config, torch.from_numpy(x))
    assert got.shape == (2, 4 * T, CTX)
    assert rel_err(got, want) < 1e-4


def test_tokenizer_cache():
    for prompts in (["Rotating view of a scene"], [""], ["", "Rotating view of a scene"]):
        np.testing.assert_array_equal(tokenizer.tokenize(prompts), jtok.tokenize(prompts))
    with pytest.raises(ValueError):
        tokenizer.tokenize(["a prompt that is not cached"])


@pytest.mark.parametrize("zero_snr,dynamic", [(True, True), (False, False)])
def test_schedules_and_ddim_params(zero_snr, dynamic):
    js = jS.make_schedule(rescale_betas_zero_snr=zero_snr, use_dynamic_rescale=dynamic)
    ts = S.make_schedule(rescale_betas_zero_snr=zero_snr, use_dynamic_rescale=dynamic)
    for f in dataclasses.fields(js):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                                   rtol=1e-6, atol=0)
    for steps, method in ((50, "uniform_trailing"), (10, "uniform_trailing"), (25, "uniform")):
        jp = jS.make_ddim_params(js, steps, eta=1.0, method=method)
        tp = S.make_ddim_params(ts, steps, eta=1.0, method=method)
        np.testing.assert_array_equal(tp.timesteps.numpy(), np.asarray(jp.timesteps))
        for f in dataclasses.fields(jp):
            np.testing.assert_allclose(getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name)),
                                       rtol=1e-6, atol=0)


def test_q_sample_matches_reference():
    js, ts = jS.make_schedule(), S.make_schedule()
    rng = np.random.default_rng(14)
    x0, noise = (rng.standard_normal((3, T, 6, 7, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 421, 999], np.int32)
    want = jS.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = S.q_sample(ts, torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_ddim_step_and_cfg():
    sched_j, sched_t = jS.make_schedule(), S.make_schedule()
    pj, pt = jS.make_ddim_params(sched_j, 10), S.make_ddim_params(sched_t, 10)
    rng = np.random.default_rng(10)
    x, vc, vu, nz = (rng.standard_normal((1, T, 6, 7, 4)).astype(np.float32) for _ in range(4))

    def jf(v):
        return lambda x_, t_: jnp.asarray(v) + 0.0 * x_

    def tf(v):
        return lambda x_, t_: torch.from_numpy(v) + 0.0 * x_

    for index in (9, 4, 0):
        t = np.full((1,), int(np.asarray(pj.timesteps)[index]), np.int32)
        mo_j, corr_j = jddim.cfg_model_output(jf(vc), jf(vu), jnp.asarray(x), jnp.asarray(t), 7.5, 0.7)
        mo_t, corr_t = ddim.cfg_model_output(tf(vc), tf(vu), torch.from_numpy(x),
                                             torch.from_numpy(t).long(), 7.5, 0.7)
        np.testing.assert_allclose(mo_t.numpy(), np.asarray(mo_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(corr_t.numpy(), np.asarray(corr_j), atol=1e-6, rtol=0)
        oj = jddim.ddim_step(sched_j, pj, jnp.int32(index), jnp.asarray(x), mo_j, jnp.asarray(nz))
        ot = ddim.ddim_step(sched_t, pt, index, torch.from_numpy(x), mo_t, torch.from_numpy(nz))
        for a, b in zip(ot, oj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_init_has_the_jax_key_set_and_shapes():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    tparams = init.init_diffusion_params(pm, ps, seed=3, dtype=torch.bfloat16)
    for name in model.DiffusionParams._fields:
        j, t = getattr(jparams, name), getattr(tparams, name)
        assert sorted(j) == sorted(t), name
        for k in j:
            assert tuple(t[k].shape) == tuple(np.shape(j[k])), k
            assert t[k].dtype == torch.bfloat16
    w = tparams.unet["input_blocks.1.0.in_layers.2.weight"].float()
    assert 0.015 < float(w.std()) < 0.025  # N(0, 0.02)
