"""Stable Video Diffusion XT in the port against the plain reference
(plain_reference/svd_xt.py: diffusers' modules written out in NCHW float32
PyTorch, independent of the port) on the CPU, at a toy size with seeded
random weights in the diffusers layout.

Tolerances (relative L2 unless said otherwise): the port and the reference
both compute in float32, in other layouts and orders of summation, so
they agree to about 1e-6; 1e-4 leaves room for that and is still well
below what one bfloat16 rounding of the activations gives (about 4e-3,
`test_bf16_compute_fails_the_unet_tolerance`).

- the spatio-temporal UNet; the temporal decoder chunk by chunk (and that a
  chunk is one video: decoding the frames together differs from decoding
  them apart); the projected CLIP image embedding; the conditioning;
- the Karras sigmas (700 .. 0.002, then 0) and the Euler step;
- the guided Euler EDM step's x_prev and guidance term against the
  reference's guided step from the program's pair;
- the random-weight key set against the reference's enumeration of the
  diffusers names (UNet, VAE, image encoder), and at SVD-XT's widths the
  published parameter counts; a file in that layout loads into the engine;
- `train_guidedvd --svd_ckpt` through one event at a tiny preset;
- the span "svd.temporal" under a profiler;
- the benchmark's frozen copy of the reference (benchmark/reference/svd)
  holds the same code as plain_reference/svd_xt.py.
"""

import ast
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from guidedvd3dgs_tpu_torch import train_baseline as port_baseline_cli
from guidedvd3dgs_tpu_torch import train_guidedvd as port_cli
from guidedvd3dgs_tpu_torch.diffusion import clip, convert, synthesis, vae as pvae
from guidedvd3dgs_tpu_torch.diffusion.model import SVDConfig
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance as dg
from guidedvd3dgs_tpu_torch.diffusion.samplers import euler_edm as ee
from guidedvd3dgs_tpu_torch.diffusion.schedules import make_edm_params
from guidedvd3dgs_tpu_torch.diffusion.unet_st import STUNetConfig, unet_st_apply
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance
from guidedvd3dgs_tpu_torch.scene import synthetic
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.utils.tracing import PREFIX

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("plain_svd_xt", ROOT / "plain_reference" / "svd_xt.py")
R = importlib.util.module_from_spec(_spec)
sys.modules["plain_svd_xt"] = R
_spec.loader.exec_module(R)

TOL = 1e-4
T, HW = 5, 32  # frames, engine size (latent 16x16)

# the toy configuration, as the benchmark's JSON dict and as the port's
CFG = {
    "unet": dict(in_channels=8, out_channels=4, model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                 attention_resolutions=[1], num_head_channels=16, transformer_depth=1, context_dim=24,
                 adm_in_channels=24, addition_time_embed_dim=8),
    "vae": dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, in_channels=3, out_ch=3, z_channels=4, double_z=True,
                embed_dim=4, scale_factor=0.18215, resolution=32, attn_resolutions=[]),
    "decoder": dict(block_out_channels=[32, 64], layers_per_block=1, latent_channels=4, out_channels=3,
                    scaling_factor=0.18215),
    "clip_vision": dict(width=48, heads=4, layers=2, patch_size=32, image_size=64, projection_dim=24),
}
TRAFFIC = dict(fps=7, motion_bucket_id=127, noise_aug_strength=0.02, decode_chunk=3, rho_scale=0.2)


def port_config(compute_dtype="float32") -> SVDConfig:
    t = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa: E731
    vis = {k: v for k, v in CFG["clip_vision"].items() if k != "projection_dim"}
    return SVDConfig(unet=STUNetConfig(**t(CFG["unet"])), vae=pvae.VAEConfig(**t(CFG["vae"])),
                     decoder=pvae.TemporalDecoderConfig(**t(CFG["decoder"])), vision=clip.VisionConfig(**vis),
                     compute_dtype=compute_dtype)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def cl(x):
    """(B, T, C, H, W) or (N, C, H, W) -> channels-last."""
    return x.movedim(-3, -1)


@pytest.fixture(scope="module")
def weights():
    sd = convert.random_svd_state_dict(port_config(), seed=3)
    # mix factors and norms away from their initial values, so a swapped blend shows
    gen = torch.Generator().manual_seed(9)
    for k in sd:
        if k.endswith("mix_factor") or k.endswith("norm1.weight") or k.endswith("mid_block.attentions.0.to_q.bias"):
            sd[k] = sd[k] + torch.randn(sd[k].shape, generator=gen)
    return sd, convert.convert_svd_state_dict(sd), R.split(sd)


def unet_inputs(seed=1, b=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, T, HW // 2, HW // 2, 8), generator=g)
    return (x, torch.tensor([0.3, -1.2])[:b], torch.randn((b, 1, 24), generator=g),
            torch.tensor([[6.0, 127.0, 0.02], [3.0, 20.0, 0.1]])[:b])


def test_unet_matches_plain_reference(weights):
    _, params, ref = weights
    x, t, ctx, ids = unet_inputs()
    got = unet_st_apply(params.unet, port_config().unet, x, t, ctx, ids)
    want = R.unet_forward(ref[0], CFG["unet"], x.movedim(-1, 2), t, ctx, ids)
    assert rel(got, cl(want)) < TOL


def test_bf16_compute_fails_the_unet_tolerance(weights):
    _, params, ref = weights
    x, t, ctx, ids = unet_inputs()
    got = unet_st_apply(params.unet, port_config().unet, x.bfloat16(), t, ctx.bfloat16(), ids).float()
    want = R.unet_forward(ref[0], CFG["unet"], x.movedim(-1, 2), t, ctx, ids)
    assert rel(got, cl(want)) > 10 * TOL


def test_temporal_decoder_chunk_by_chunk(weights):
    _, params, ref = weights
    cfg = port_config()
    z = torch.randn((T, HW // 2, HW // 2, 4), generator=torch.Generator().manual_seed(2))
    got = synthesis.decode_chunks(params, cfg, z, TRAFFIC["decode_chunk"])
    want = torch.cat([R.temporal_decode(ref[1], CFG["decoder"], z[c0:c0 + 3].movedim(-1, 1)) for c0 in (0, 3)])
    assert rel(got, cl(want)) < TOL
    whole = cl(R.temporal_decode(ref[1], CFG["decoder"], z.movedim(-1, 1)))
    assert rel(got, whole) > 100 * TOL  # the chunk's frames are one video


def test_clip_image_embedding_and_conditioning(weights):
    _, params, ref = weights
    cfg = port_config()
    g = torch.Generator().manual_seed(4)
    video, aug = torch.rand((T, HW, HW, 3), generator=g) * 2 - 1, torch.randn((1, HW, HW, 3), generator=g)
    got = clip.image_embed(params.clip_image, cfg.vision, video[:2])
    want = R.image_embed(ref[2], CFG["clip_vision"], video[:2].movedim(-1, 1))
    assert got.shape == (2, 24) and rel(got, want) < TOL
    scfg = synthesis.SVDSynthesisConfig(decode_chunk=3)
    cond, uncond = synthesis.build_svd_conditioning(params, cfg, scfg, video, aug_noise=aug)
    rc, ru = R.conditioning(ref, CFG, TRAFFIC, video.movedim(-1, 1), aug.movedim(-1, 1))
    assert rel(cond.context, rc.context) < TOL and rel(cond.concat, cl(rc.concat)) < TOL
    assert torch.equal(cond.time_ids, rc.time_ids) and not uncond.context.any() and not uncond.concat.any()


def test_karras_sigmas_and_euler_step():
    edm = make_edm_params(25, 0.002, 700.0, 7.0)
    ref = R.karras(25, 0.002, 700.0, 7.0, "cpu")
    assert edm.sigmas.shape == (26,) and float(edm.sigmas[-1]) == 0.0
    assert math.isclose(float(edm.sigmas[0]), 700.0, rel_tol=1e-6)
    assert math.isclose(float(edm.sigmas[-2]), 0.002, rel_tol=1e-6)
    assert bool((edm.sigmas[1:] < edm.sigmas[:-1]).all())
    for name, b in zip(("sigmas", "c_skip", "c_out", "c_in", "c_noise"), ref):
        a = getattr(edm, name)
        assert torch.allclose(a, b, rtol=1e-6, atol=0)
    assert torch.allclose(edm.c_noise, 0.25 * torch.log(edm.sigmas[:-1]), rtol=1e-5)
    g = torch.Generator().manual_seed(5)
    x, d = torch.randn((1, T, 4, 4, 4), generator=g), torch.randn((1, T, 4, 4, 4), generator=g)
    for k in (0, 12, 24):
        assert torch.allclose(ee.euler_step(edm, k, x, d), R.euler(x, k, ref, d), rtol=1e-6, atol=1e-6)
    # the last step lands on D (sigma_next = 0), to float32's rounding of x - d
    assert torch.allclose(ee.euler_step(edm, 24, x, d), d, rtol=0, atol=1e-6)


def test_guided_step_x_prev_and_guidance_term(weights):
    _, params, ref = weights
    cfg = port_config()
    g = torch.Generator().manual_seed(6)
    video, aug = torch.rand((T, HW, HW, 3), generator=g) * 2 - 1, torch.randn((1, HW, HW, 3), generator=g)
    images, masks = torch.rand((T, 3, 48, 48), generator=g), torch.ones((T, 1, 48, 48))
    masks[:, :, 10:30, 5:25] = 0.0
    scfg = synthesis.SVDSynthesisConfig(euler=ee.EulerConfig(num_steps=4), decode_chunk=3)
    cond, uncond = synthesis.build_svd_conditioning(params, cfg, scfg, video, aug_noise=aug)
    edm, scales = scfg.euler.params(), ee.frame_scales(scfg.euler, T)
    bufs = resize_guidance(images, HW, HW, masks=masks)
    rule = ee.EulerEDMRule(edm, scales, dg.GuidedSampleConfig(decode_chunk=3))
    rc, ru = R.conditioning(ref, CFG, TRAFFIC, video.movedim(-1, 1), aug.movedim(-1, 1))
    rloss = R.guidance_loss(bufs.images.movedim(-1, 1), bufs.masks.movedim(-1, 1), 0.5)
    redm = R.karras(4, 0.002, 700.0, 7.0, "cpu")
    rscales = R.frame_scales(1.0, 3.0, T, "cpu")
    for k in (1, 3):
        x = torch.randn((1, T, HW // 2, HW // 2, 4), generator=g) * float(edm.sigmas[k])
        pairs = []
        real = dg.pair_forward
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dg, "pair_forward", lambda *a, **kw: pairs.append(real(*a, **kw)) or pairs[-1])
            x_prev, _, rho = dg.rule_step(params, cfg, rule, cond, uncond, make_guidance_fn(bufs), 1.0, x, k, None)
        vc, vu = pairs[0]
        rvc, rvu = R.pair(ref, CFG, torch.float32, x.movedim(-1, 2), k, redm, rc, ru)
        assert rel(vc, cl(rvc)) < TOL and rel(vu, cl(rvu)) < TOL
        rvc, rvu = vc.movedim(-1, 2), vu.movedim(-1, 2)  # the reference follows the program's pair
        x_ref = cl(R.guided_step(ref, CFG, torch.float32, TRAFFIC, x.movedim(-1, 2), k, redm, rscales, rc, ru, rloss,
                                 rvc, rvu))
        unguided = cl(R.euler(x.movedim(-1, 2), k, redm, R.denoised(x.movedim(-1, 2), k, redm, rscales, rvc, rvu)))
        assert float(rho) > 0
        assert rel(x_prev, x_ref) < TOL
        assert rel(x_prev - unguided, x_ref - unguided) < 10 * TOL  # the guidance term alone


def test_random_layout_is_the_diffusers_key_set(weights, tmp_path):
    sd = weights[0]
    want = R.layout(CFG)
    assert set(sd) == set(want) and all(tuple(sd[k].shape) == want[k][0] for k in want)
    full = convert.svd_layout(SVDConfig())
    full_cfg = {"unet": dict(in_channels=8, out_channels=4, model_channels=320, channel_mult=[1, 2, 4, 4],
                             num_res_blocks=2, attention_resolutions=[4, 2, 1], num_head_channels=64,
                             transformer_depth=1, context_dim=1024, adm_in_channels=768,
                             addition_time_embed_dim=256),
                "vae": dict(ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, in_channels=3, z_channels=4, embed_dim=4),
                "decoder": dict(block_out_channels=[128, 256, 512, 512], layers_per_block=2, latent_channels=4,
                                out_channels=3),
                "clip_vision": dict(width=1280, heads=16, layers=32, patch_size=14, image_size=224,
                                    projection_dim=1024)}
    assert {k: v[0] for k, v in full.items()} == {k: v[0] for k, v in R.layout(full_cfg).items()}
    count = {pre: sum(math.prod(s) for k, (s, _) in full.items() if k.startswith(pre))
             for pre in ("unet.", "vae.", "image_encoder.")}
    # the UNet's and the image encoder's published sizes; the VAE's as this layout counts it
    assert count == {"unet.": 1_524_623_082, "vae.": 97_742_847, "image_encoder.": 632_076_800}
    assert "unet.down_blocks.0.attentions.0.temporal_transformer_blocks.0.ff_in.net.0.proj.weight" in full
    assert "vae.decoder.time_conv_out.weight" in full and "vae.post_quant_conv.weight" not in full
    assert full["unet.up_blocks.1.resnets.0.spatial_res_block.conv1.weight"][0] == (1280, 2560, 3, 3)


def toy_engine_cls(cfg):
    class ToyEngine(pg.SVDEngine):
        def __init__(self, params, _cfg, **kwargs):
            kwargs.update(video_length=T, height=HW, width=HW,
                          scfg=synthesis.SVDSynthesisConfig(euler=ee.EulerConfig(num_steps=2), decode_chunk=3))
            super().__init__(params, cfg, **kwargs)
    return ToyEngine


def test_checkpoint_file_loads_into_the_engine(weights, tmp_path):
    sd, params, _ = weights
    path = tmp_path / "svd.pt"
    torch.save(sd, path)
    loaded = convert.load_svd_checkpoint(str(path))
    for part in ("unet", "vae", "clip_image"):
        a, b = getattr(loaded, part), getattr(params, part)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), part
    eng = toy_engine_cls(port_config())(loaded, None)
    g = torch.Generator().manual_seed(8)
    renders = torch.rand((T, 40, 40, 3), generator=g)
    noise = synthesis.SynthesisNoise(encode_eps=torch.randn((1, HW, HW, 3), generator=g),
                                     x_T=torch.randn((1, T, HW // 2, HW // 2, 4), generator=g))
    guidance = (torch.rand((T, 3, 40, 40), generator=g), torch.ones((T, 1, 40, 40)), torch.ones((T, 1, 40, 40)))
    video = eng.generate(renders, *guidance, noise=noise)
    plain = eng.generate(renders, *guidance, noise=noise, no_guidance=True)
    assert video.shape == plain.shape == (T, 3, HW, HW) and bool(torch.isfinite(video).all())
    assert 0 < float((video - plain).abs().max()) and bool(torch.isfinite(plain).all())
    # the diffusers repository's own layout: a folder a sub-model, .bin weights
    for part, folder in (("unet.", "unet"), ("vae.", "vae"), ("image_encoder.", "image_encoder")):
        (tmp_path / "repo" / folder).mkdir(parents=True)
        torch.save({k[len(part):]: v for k, v in sd.items() if k.startswith(part)},
                   tmp_path / "repo" / folder / "diffusion_pytorch_model.bin")
    from_dir = convert.load_svd_checkpoint(str(tmp_path / "repo"))
    assert all(torch.equal(getattr(from_dir, p)[k], getattr(params, p)[k]) for p in ("unet", "vae", "clip_image")
               for k in getattr(params, p))
    with pytest.raises(ValueError, match="recur_steps"):
        ee.EulerEDMRule(eng.scfg.euler.params(), ee.frame_scales(eng.scfg.euler, T),
                        dg.GuidedSampleConfig(recur_steps=2))


def test_cli_svd_ckpt_runs_an_event(weights, monkeypatch, tmp_path):
    sd = weights[0]
    ckpt = tmp_path / "svd.pt"
    torch.save(sd, ckpt)
    cfg = port_config()
    monkeypatch.setattr(port_cli, "SVDConfig", lambda compute_dtype="float32": cfg)
    monkeypatch.setattr(port_cli, "SVDEngine", toy_engine_cls(cfg))
    src, base, mdl = tmp_path / "scene", tmp_path / "baseline", tmp_path / "guided"
    synthetic.make_scene(str(src), height=48, width=64, n_gt=3000, n_init=400, n_cams=12, n_train=3, device="cpu")
    common = ["-s", str(src), "--dataset", "colmap", "--n_views", "3", "--eval", "--device", "cpu"]
    port_baseline_cli.main(common + ["-m", str(base), "--iterations", "30", "--test_iterations", "30",
                                     "--save_iterations", "30"])
    trainer = port_cli.main(common + [
        "-m", str(mdl), "--baseline_path", str(base), "--baseline_iteration", "30", "--svd_ckpt", str(ckpt),
        "--iterations", "6", "--test_iterations", "6", "--save_iterations", "6", "--start_sample_pseudo", "2",
        "--end_sample_pseudo", "6", "--guidance_vd_iter", "15", "--save_pred_x0"])
    assert isinstance(trainer.engine, pg.SVDEngine) and trainer.events_run == 1
    assert (mdl / "diffusion_events" / "train_iter1" / "diffusion0.mp4").exists() or \
        (mdl / "diffusion_events" / "train_iter1" / "diffusion0").is_dir()
    assert (mdl / "point_cloud" / "iteration_6" / "point_cloud.ply").exists()
    event = mdl / "diffusion_events" / "train_iter1"
    assert all((event / f"pred_x0_step{i:03d}.mp4").exists() or (event / f"pred_x0_step{i:03d}").is_dir()
               for i in range(2))  # each Euler step's denoised video


def test_svd_temporal_span_under_the_profiler(weights):
    _, params, _ = weights
    x, t, ctx, ids = unet_inputs(b=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        unet_st_apply(params.unet, port_config().unet, x, t, ctx, ids)
        pvae.temporal_decode(params.vae, port_config().decoder, x[0, :3, ..., :4])
    names = [e.name for e in prof.events()]
    # two ResBlocks, two transformers (each its frame embedding and its block), the decoder's
    # ResBlocks and time_conv_out
    assert names.count(PREFIX + "svd.temporal") >= 2 + 2 * 2 + 2
    assert PREFIX + "nn.group_norm" in names and PREFIX + "nn.attention" in names


def test_benchmark_copy_of_the_reference_holds_the_same_code():
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))  # the module docstring left out

    frozen = ROOT / "benchmark" / "reference" / "svd" / "svd_xt.py"
    assert body(frozen) == body(ROOT / "plain_reference" / "svd_xt.py")
