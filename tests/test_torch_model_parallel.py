"""The device mesh of the port (`parallel/mesh.py`, `parallel/model_parallel.py`,
`parallel/data_parallel.py::make_dp_train_step`, the sharded engine), against
the JAX package on the CPU.

- `spec_for` equals JAX's `_spec_for` for every parameter name and shape at
  n_model 2 and 4, at the reduced config of tests/test_parallel.py and at
  the full `inference_pvd_1024` widths (names and shapes from JAX's init
  with its numpy sampler giving zero-stride views: nothing allocated).
- `basic_transformer_block` on a ["cpu", "cpu"] mesh against JAX's on a
  2-device mesh and against the unsharded port, within 1e-5 in float32: 4
  heads split over the model axis (each device attends to 2), 5 heads
  gathered on the home device.
- `ViewCrafterEngine(mesh=...)`: a guided request of two DDIM steps at the
  toy widths against the unsharded engine on the same noise, within JAX's
  own 2e-3 for its sharded engine (tests/test_parallel.py:172).
- The guided pair's VJP (`ddim_guidance.pair_vjp`, dL/dx of pred_x0
  through both branches' UNet, the gradient the guided sampler uses) with
  sharded weights against JAX's `jax.vjp` of the same pred_x0 (1e-4 of max
  |dL/dx|, the tolerance of tests/test_torch_guided_sampler.py); against
  the unsharded port within 2x the distance that x moved by 2^-24 of each
  value puts the unsharded one (1.9e-5 against 1.8e-5 in L2: the CFG
  combination subtracts the branches' nearly equal gradients and amplifies
  their rounding); each branch's UNet VJP against the unsharded one's
  within 1e-5 in L2 (2.2e-6: the partial sums in another order).
- `make_dp_train_step` on a (2, 1) CPU mesh against JAX's on 2 CPU
  devices (the tolerances of tests/test_torch_parallel.py) and bitwise
  against `train_step_dp`, which it is on one device's copies.
- The CLI's `guidance_mesh`: N CPU entries on the CPU; on CUDA it raises
  where the host has too few cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from guidedvd3dgs_tpu.config import OptimizationParams as JOpt
from guidedvd3dgs_tpu.diffusion import attention as jattn
from guidedvd3dgs_tpu.diffusion import clip as jclip
from guidedvd3dgs_tpu.diffusion import init as jinit
from guidedvd3dgs_tpu.diffusion import model as jmodel
from guidedvd3dgs_tpu.diffusion import resampler as jres
from guidedvd3dgs_tpu.diffusion import schedules as jS
from guidedvd3dgs_tpu.diffusion import synthesis as jsyn
from guidedvd3dgs_tpu.diffusion import unet3d as junet
from guidedvd3dgs_tpu.diffusion import vae as jvae
from guidedvd3dgs_tpu.diffusion.samplers import ddim_guidance as jdg
from guidedvd3dgs_tpu.parallel import data_parallel as jdp
from guidedvd3dgs_tpu.parallel import mesh as jmesh
from guidedvd3dgs_tpu.parallel import model_parallel as jmp
from guidedvd3dgs_tpu.train.baseline import lrs_for as jlrs_for
from guidedvd3dgs_tpu_torch import train_guidedvd as port_cli
from guidedvd3dgs_tpu_torch.config import OptimizationParams
from guidedvd3dgs_tpu_torch.convert import diffusion_params_from_numpy, state_from_numpy
from guidedvd3dgs_tpu_torch.diffusion import attention as pattn
from guidedvd3dgs_tpu_torch.diffusion import model as pmodel
from guidedvd3dgs_tpu_torch.diffusion import schedules as pS
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance as pdg
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.parallel import make_dp_train_step, make_mesh, stack_cameras, train_step_dp
from guidedvd3dgs_tpu_torch.parallel import model_parallel as pmp
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.train.baseline import lrs_for

from test_torch_diffusion_models import T, toy_configs
from test_torch_parallel import _cams, _jax_state

torch.set_num_threads(2)

CPU_MESH = ("cpu", "cpu")
BLOCK_TOL = 1e-5
ENGINE_TOL = 2e-3
VJP_TOL = 1e-4  # max abs over max |dL/dx|, against JAX
VJP_RATIO = 2.0  # the pair's VJP: times the yardstick of x moved by 2^-24
VJP_SHARD_TOL = 1e-5  # a branch's VJP: L2 over |dL/dx|, against the unsharded port


def _reduced_configs():
    """tests/test_parallel.py:129-149's reduced ViewCrafter config."""
    mcfg = jmodel.LatentDiffusionConfig(
        unet=junet.UNetConfig(model_channels=320, num_res_blocks=1, attention_resolutions=(1, 2),
                              channel_mult=(1, 2), num_head_channels=64, context_dim=1024, temporal_length=4),
        vae=jvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16,
                           z_channels=4))
    scfg = jsyn.SynthesisConfig(
        ddim_steps=2, text_config=jclip.TextConfig(width=1024, heads=16, layers=2),
        vision_config=jclip.VisionConfig(width=64, heads=4, layers=2, patch_size=32, image_size=224),
        resampler_config=jres.ResamplerConfig(dim=1024, depth=1, dim_head=64, heads=12, num_queries=4,
                                              embedding_dim=64, output_dim=1024, video_length=4))
    return mcfg, scfg


CONFIGS = {"reduced": _reduced_configs,
           "inference_pvd_1024": lambda: (jmodel.LatentDiffusionConfig(), jsyn.SynthesisConfig())}


def _dim_of(spec) -> "int | None":
    dims = [i for i, a in enumerate(spec) if a == jmesh.MODEL_AXIS]
    return dims[0] if dims else None


@pytest.mark.parametrize("config,n_model", [(c, n) for c in CONFIGS for n in (2, 4)])
def test_spec_for_matches_reference(config, n_model, monkeypatch):
    mcfg, scfg = CONFIGS[config]()
    # JAX's init samples on the host with numpy (jax.eval_shape cannot
    # trace it): its samples become zero-stride views, so the full widths'
    # 2.5e9 weights take no memory
    monkeypatch.setattr(jinit._Init, "_normal", lambda self, shape: np.broadcast_to(np.float32(0.0), shape))
    shapes = jinit.init_diffusion_params(mcfg, scfg, jax.random.key(0))
    split = {0: 0, 1: 0}
    for part, params in zip(shapes._fields, shapes):
        for name, s in params.items():
            want = _dim_of(jmp._spec_for(name, s, n_model))
            got = pmp.spec_for(name, tuple(s.shape), n_model)
            assert got == want, (part, name, s.shape, got, want)
            if got is not None:
                split[got] += 1
    assert split[0] > 0 and split[1] > 0  # both kinds of split occur


def test_shard_params_places_the_pieces():
    rng = np.random.default_rng(0)
    p = {"blk.to_q.weight": torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)),
         "blk.to_out.0.weight": torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32)),
         "blk.norm.weight": torch.ones(6), "tok.weight": torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))}
    mesh = make_mesh(n_data=1, n_model=2, devices=CPU_MESH)
    sp = pmp.shard_params(p, mesh)
    assert isinstance(sp["blk.norm.weight"], torch.Tensor)
    for name, dim in (("blk.to_q.weight", 0), ("blk.to_out.0.weight", 1), ("tok.weight", 0)):
        w = sp[name]
        assert isinstance(w, pmp.Sharded) and w.dim == dim and w.shape == p[name].shape, name
        assert torch.equal(torch.cat(w.shards, dim=dim), p[name]), name
    ids = torch.tensor([[0, 9, 4, 5, 7]])
    assert torch.equal(pmp.embedding(sp["tok.weight"], ids), p["tok.weight"][ids])
    video = torch.arange(2 * 4 * 3).reshape(2, 4, 3, 1, 1).float()
    halves = pmp.shard_video_batch(video, make_mesh(n_data=2, n_model=1, devices=CPU_MESH))
    assert [h.shape[1] for h in halves] == [2, 2] and torch.equal(torch.cat(halves, 1), video)
    with pytest.raises(ValueError, match="do not split"):
        pmp.shard_video_batch(video[:, :3], make_mesh(n_data=2, n_model=1, devices=CPU_MESH))
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(n_data=2, n_model=2, devices=CPU_MESH)


def _block_params(heads: int, dh: int = 16, d: int = 64, ctx_dim: int = 24, seed: int = 0):
    """A transformer block with the image cross-attention, float32 numpy."""
    rng = np.random.default_rng(seed)
    inner = heads * dh

    def w(*shape):
        return rng.normal(size=shape, scale=0.1).astype(np.float32)

    p = {}
    for attn in ("attn1", "attn2"):
        kin = d if attn == "attn1" else ctx_dim
        p[f"blk.{attn}.to_q.weight"] = w(inner, d)
        for nm in ("to_k", "to_v") + (("to_k_ip", "to_v_ip") if attn == "attn2" else ()):
            p[f"blk.{attn}.{nm}.weight"] = w(inner, kin)
        p[f"blk.{attn}.to_out.0.weight"] = w(d, inner)
        p[f"blk.{attn}.to_out.0.bias"] = w(d)
    p["blk.attn2.alpha"] = np.array(0.3, np.float32)
    p["blk.ff.net.0.proj.weight"] = w(8 * d, d)
    p["blk.ff.net.0.proj.bias"] = w(8 * d)
    p["blk.ff.net.2.weight"] = w(d, 4 * d)
    p["blk.ff.net.2.bias"] = w(d)
    for nm in ("norm1", "norm2", "norm3"):
        p[f"blk.{nm}.weight"] = 1.0 + w(d)
        p[f"blk.{nm}.bias"] = w(d)
    return p, dh


@pytest.mark.parametrize("heads", [4, 5])
def test_transformer_block_matches_reference(heads, monkeypatch):
    p, dh = _block_params(heads)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    ctx = rng.normal(size=(2, 77 + 6, 24)).astype(np.float32)  # text, then image tokens

    jm = jmesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    jp = jmp.shard_params({k: jnp.asarray(v) for k, v in p.items()}, jm)
    repl = NamedSharding(jm, P())
    fn = jax.jit(lambda p_, x_, c_: jattn.basic_transformer_block(p_, "blk", x_, c_, heads, dh,
                                                                  image_cross_attention=True))
    ref = np.asarray(fn(jp, jax.device_put(jnp.asarray(x), repl), jax.device_put(jnp.asarray(ctx), repl)))

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    run = lambda params: pattn.basic_transformer_block(params, "blk", torch.from_numpy(x), torch.from_numpy(ctx),
                                                       heads, dh, image_cross_attention=True)
    whole = run(tp)
    sp = pmp.shard_params(tp, make_mesh(n_data=1, n_model=2, devices=CPU_MESH))
    calls = []
    real = pattn.attention
    monkeypatch.setattr(pattn, "attention", lambda q, *a, **k: calls.append(q.shape[1]) or real(q, *a, **k))
    split = run(sp)
    assert split.shape == x.shape and torch.isfinite(split).all()
    np.testing.assert_allclose(split.numpy(), ref, atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=BLOCK_TOL, rtol=0)
    heads_split = pattn._head_parallel(sp, "blk.attn1", ("to_q", "to_k", "to_v"), heads) is not None
    assert heads_split == (heads % 2 == 0)
    # 3 attentions (self, text, image) a device with heads / 2 heads each,
    # or 3 over every head on the home device
    assert calls == ([heads // 2] * 6 if heads_split else [heads] * 3)


def test_sharded_engine_matches_the_unsharded_engine():
    _, _, pm, ps = toy_configs()
    jm, js, _, _ = toy_configs()
    tparams = diffusion_params_from_numpy(jinit.init_diffusion_params(jm, js, jax.random.key(0)), device="cpu")
    mesh = make_mesh(n_data=1, n_model=2, devices=CPU_MESH)
    hw = 32
    base = pg.ViewCrafterEngine(tparams, pm, ps, video_length=T, height=hw, width=hw)
    tp = pg.ViewCrafterEngine(tparams, pm, ps, video_length=T, height=hw, width=hw, mesh=mesh)
    assert tp.device == torch.device("cpu") and tp.devices == (torch.device("cpu"),)
    assert isinstance(tp.params.unet["input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"], pmp.Sharded)
    assert isinstance(tp.params.unet["input_blocks.1.1.transformer_blocks.0.attn1.to_out.0.weight"], pmp.Sharded)
    rngd = np.random.default_rng(3)
    pc = torch.from_numpy(rngd.uniform(size=(T, 40, 40, 3)).astype(np.float32))
    gimg = torch.from_numpy(rngd.uniform(size=(T, 3, 40, 40)).astype(np.float32))
    gmask = torch.from_numpy((rngd.uniform(size=(T, 1, 40, 40)) > 0.4).astype(np.float32))
    out = [e.generate(pc, gimg, gmask, None, generator=torch.Generator().manual_seed(5)) for e in (base, tp)]
    assert out[1].shape == (T, 3, hw, hw) and torch.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), atol=ENGINE_TOL, rtol=0)


def test_sharded_pair_vjp_matches_reference_and_unsharded():
    jm, js, pm, ps = toy_configs()
    jparams = jinit.init_diffusion_params(jm, js, jax.random.key(0))
    tparams = diffusion_params_from_numpy(jparams, device="cpu")
    sparams = pmp.shard_params(tparams, make_mesh(n_data=1, n_model=2, devices=CPU_MESH))
    rng = np.random.default_rng(17)
    lat = (1, T, 16, 16, 4)
    x, concat, cot = (rng.standard_normal(lat).astype(np.float32) for _ in range(3))
    ctx = [rng.standard_normal((1, 8, jm.unet.context_dim)).astype(np.float32) for _ in range(2)]
    fs = np.full((1,), 10, np.int32)
    index = 1
    jsched = jm.schedule()
    jpr = jS.make_ddim_params(jsched, js.ddim_steps, eta=js.ddim_eta, method=js.timestep_spacing)
    jcfg = jdg.GuidedSampleConfig()
    cu = jmodel.Conditioning(jnp.asarray(np.concatenate(ctx)), jnp.asarray(np.concatenate([concat, concat])),
                             jnp.asarray(np.concatenate([fs, fs])))

    def jpred_x0(xv):  # JAX _guided_step's pred_x0_of_x, pair_mode "batched"
        t = jnp.broadcast_to(jpr.timesteps[index], (1,))
        vs = jmodel.apply_model(jparams, jm, jnp.concatenate([xv, xv]), jnp.concatenate([t, t]), cu)
        mo = vs[1:] + jcfg.cfg_scale * (vs[:1] - vs[1:])
        mo = jS.rescale_noise_cfg(mo, vs[:1], jcfg.guidance_rescale)
        return jS.predict_start_from_z_and_v(jsched, xv, t, mo) * (jpr.scale_arr_prev[index] / jpr.scale_arr[index])

    want = np.asarray(jax.vjp(jpred_x0, jnp.asarray(x))[1](jnp.asarray(cot))[0])
    tsched = pm.schedule()
    tpr = pS.make_ddim_params(tsched, ps.ddim_steps, eta=ps.ddim_eta, method=ps.timestep_spacing)
    cond, uncond = (pmodel.Conditioning(torch.from_numpy(c), torch.from_numpy(concat), torch.from_numpy(fs).long())
                    for c in ctx)
    tx, tcot = torch.from_numpy(x), torch.from_numpy(cot)
    sgn = torch.from_numpy(rng.integers(0, 2, lat).astype(np.float32) * 2.0 - 1.0)

    def vjp(p, xv):
        rule = pdg.DDIMRule(tsched, tpr, pdg.GuidedSampleConfig())
        vc, vu = pdg.pair_forward(p, pm, rule, cond, uncond, xv, index)
        return pdg.pair_vjp(p, pm, rule, cond, uncond, xv, index, vc, vu, tcot)

    def branch_vjp(p, c):
        xg = tx.clone().requires_grad_()
        return torch.autograd.grad(pmodel.apply_model(p, pm, xg, tpr.timesteps[index].expand(1), c), xg, tcot)[0]

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    got, base, moved = vjp(sparams, tx), vjp(tparams, tx), vjp(tparams, tx * (1.0 + 2.0 ** -24 * sgn))
    assert got.shape == lat and torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= VJP_TOL * np.abs(want).max()
    assert l2(got, base) <= VJP_RATIO * l2(moved, base)
    for c in (cond, uncond):
        assert l2(branch_vjp(sparams, c), branch_vjp(tparams, c)) <= VJP_SHARD_TOL


def test_dp_train_step_matches_reference_and_train_step_dp():
    cams, pcams, gts = _cams(2)
    jopt, opt = JOpt(), OptimizationParams()
    jm = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    jstate0 = _jax_state()
    sh_b = NamedSharding(jm, P(jmesh.DATA_AXIS))
    jstep = jdp.make_dp_train_step(jm, sh_degree=0, lambda_dssim=0.2, backend="dense")
    jout, jmet = jstep(jax.device_put(jstate0, NamedSharding(jm, P())),
                       jax.device_put(jdp.stack_cameras([c.raster_camera() for c in cams]), sh_b),
                       jax.device_put(jnp.asarray(gts), sh_b), jnp.zeros(3), jlrs_for(jopt, jopt.position_lr_init))
    jout = jax.device_get(jout)
    act = np.asarray(jout.active)

    lrs = lrs_for(opt, opt.position_lr_init)
    rcs = stack_cameras([c.raster_camera("cpu") for c in pcams])
    a, b = (state_from_numpy(jax.device_get(_jax_state())) for _ in range(2))
    step = make_dp_train_step(make_mesh(n_data=2, n_model=1, devices=CPU_MESH), sh_degree=0, lambda_dssim=0.2,
                              backend="dense")
    ma = step(a, rcs, torch.from_numpy(gts), torch.zeros(3), lrs)
    mb = train_step_dp(b, rcs, torch.from_numpy(gts), torch.zeros(3), lrs, sh_degree=0, lambda_dssim=0.2,
                       backend="dense")
    assert torch.equal(ma["loss"], mb["loss"]) and a.step == b.step == int(jout.step) == 1
    for name in PARAM_NAMES:
        assert torch.equal(getattr(a.params, name), getattr(b.params, name)), name
        np.testing.assert_allclose(getattr(a.params, name).detach().numpy(),
                                   np.asarray(getattr(jout.params, name))[act], rtol=2e-4, atol=2e-6,
                                   err_msg=name)
    for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_allclose(a.xyz_gradient_accum.numpy(), np.asarray(jout.xyz_gradient_accum)[act],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(a.denom.numpy(), np.asarray(jout.denom)[act])
    assert int(a.denom.max()) == 2
    assert abs(float(ma["loss"]) - float(jmet["loss"])) <= 1e-5
    with pytest.raises(ValueError, match="do not split"):
        step(a, stack_cameras([c.raster_camera("cpu") for c in pcams[:1]]), torch.from_numpy(gts[:1]),
             torch.zeros(3), lrs)


def test_guidance_mesh_takes_cpu_entries_and_refuses_missing_cards(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert port_cli.guidance_mesh(OptimizationParams(guidance_tp=1), cpu) is None
    mesh = port_cli.guidance_mesh(OptimizationParams(guidance_tp=2, guidance_gpu_id=1), cpu)
    assert mesh.shape == {"data": 1, "model": 2} and mesh.model_devices == (cpu, cpu) and mesh.home == cpu
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards; this host has 1"):
        port_cli.guidance_mesh(OptimizationParams(guidance_tp=2, guidance_gpu_id=0), cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = port_cli.guidance_mesh(OptimizationParams(guidance_tp=2, guidance_gpu_id=1), cuda)
    assert mesh.model_devices == (torch.device("cuda", 1), torch.device("cuda", 2))
    with pytest.raises(ValueError, match="needs 5 cards; this host has 4"):
        port_cli.guidance_mesh(OptimizationParams(guidance_tp=2, guidance_gpu_id=3), cuda)
