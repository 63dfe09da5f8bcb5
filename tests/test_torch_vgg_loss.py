"""The VGG19 perceptual loss and its two uses, port against the JAX
package on the CPU.

- `vgg_perceptual_loss` on `random_vgg19(0)` (the same draw in both
  packages, compared weight by weight) for two 48x64 images, with and
  without a mask, within rtol 1e-5 (float32 convolutions in another
  summation order); `per_sample` is each image's loss alone.
- `load_vgg19` reads the `features.*` of a torchvision-layout file, from
  the path and from VGG19_WEIGHTS, and finds nothing in an empty hub cache.
- The guidance's perceptual term (`frame_lpips_fn`): each frame's loss
  (rtol 1e-5) and one guided DDIM step (x_prev within 1e-4 of max |x_prev|,
  as tests/test_torch_guided_sampler.py, at its toy config) against JAX's
  per-frame term, with the port taking 1 and 5 frames at a time; one mean
  over the 5-frame chunk (the trap) is seen by the loss comparison. The
  decode gradients are not held element by element: the max-pools route
  the gradient of an exact tie (flat, clamped regions of a frame) to
  another element in each package.
- The perceptual pseudo term: the 12 guided steps of
  tests/test_torch_train_guided.py with `vgg_loss_fn` in both trainers, the
  same tolerances but for the rest-SH coefficients (see the test).
The step tests run a VGG19 an eighth as wide (the same layers and names,
random from a seed): the full widths at 224x224 would take minutes here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion.samplers import ddim_guidance as jdg
from guidedvd3dgs_tpu.guidance import loss_guidance as jlg
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu.utils import vgg_loss as jvl
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim_guidance as dg
from guidedvd3dgs_tpu_torch.guidance import loss_guidance as lg
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg
from guidedvd3dgs_tpu_torch.utils import vgg_loss as pvl

from test_torch_diffusion_models import T
from test_torch_guided_sampler import IMAGE, INDEX, jax_step, rel, setup  # noqa: F401
from test_torch_train_guided import COLOR_TOL, STEPS, _np, _opt, _states
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import _intrinsic

torch.set_num_threads(2)


def narrow_vgg19(seed: int = 3, div: int = 8) -> dict:
    """VGG19's layers and names at 1/div of its widths (3 input channels),
    He-normal from numpy, small random biases."""
    rng = np.random.default_rng(seed)
    p = {}
    for ci, (cin, cout) in pvl._CHANNELS.items():
        cin = 3 if ci == 0 else cin // div
        cout //= div
        p[f"features.{ci}.weight"] = rng.normal(scale=(2.0 / (9 * cin)) ** 0.5,
                                                size=(cout, cin, 3, 3)).astype(np.float32)
        p[f"features.{ci}.bias"] = rng.normal(scale=0.01, size=(cout,)).astype(np.float32)
    return p


def vgg_fns(p: dict):
    """The JAX and the port's loss functions on the same weights."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    def jfn(x, y, mask=None):
        return jvl.vgg_perceptual_loss(jp, x, y, mask)

    def tfn(x, y, mask=None, per_sample=False):
        return pvl.vgg_perceptual_loss(tp, x, y, mask, per_sample=per_sample)

    return jfn, tfn


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    x, y = (rng.uniform(size=(2, 3, 48, 64)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 1, 48, 64)) > 0.3).astype(np.float32)
    return x, y, mask


@pytest.mark.parametrize("masked", [False, True])
def test_vgg_perceptual_loss_matches_jax(images, masked):
    jp, tp = jvl.random_vgg19(0), pvl.random_vgg19(0)
    assert set(jp) == set(tp) and len(tp) == 32
    for k, v in tp.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]), err_msg=k)
    x, y, mask = images
    m = mask if masked else None
    want = float(jvl.vgg_perceptual_loss(jp, jnp.asarray(x), jnp.asarray(y),
                                         None if m is None else jnp.asarray(m)))
    tx, ty, tm = (None if a is None else torch.from_numpy(a) for a in (x, y, m))
    got = pvl.vgg_perceptual_loss(tp, tx, ty, tm)
    assert got.dim() == 0 and want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # each image alone, as JAX's call on a batch of one
    per = pvl.vgg_perceptual_loss(tp, tx, ty, tm, per_sample=True)
    assert per.shape == (2,)
    for i in range(2):
        one = jvl.vgg_perceptual_loss(jp, jnp.asarray(x[i:i + 1]), jnp.asarray(y[i:i + 1]),
                                      None if m is None else jnp.asarray(m[i:i + 1]))
        np.testing.assert_allclose(float(per[i]), float(one), rtol=1e-5)


def test_load_vgg19_reads_a_torchvision_file(tmp_path, monkeypatch):
    monkeypatch.delenv("VGG19_WEIGHTS", raising=False)
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    assert pvl.load_vgg19(None) is None and pvl.make_vgg_loss_fn(None) is None
    assert pvl.make_vgg_loss_fn(None, random_init=True) is not None
    p = narrow_vgg19()
    sd = {k: torch.from_numpy(v).double() for k, v in p.items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    path = tmp_path / "vgg19-dcbb9e9d.pth"
    torch.save(sd, path)
    for got in (pvl.load_vgg19(str(path)), pvl.load_vgg19(str(path), device="cpu")):
        assert set(got) == set(p)
        for k, v in got.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), p[k], err_msg=k)
    want = jvl.load_vgg19(str(path))
    assert set(want) == set(p)
    monkeypatch.setenv("VGG19_WEIGHTS", str(path))
    assert set(pvl.load_vgg19(None)) == set(p)
    fn = pvl.make_vgg_loss_fn(None)
    x = torch.rand(1, 3, 16, 16)
    assert float(fn(x, x)) == 0.0 and float(fn(x, 1 - x)) > 0.0


def guidance_fns(s, chunk_mean: bool = False):
    """JAX's guidance function with the per-frame VGG term (its CLI's
    lambda) and the port's with frame_lpips_fn (or, with `chunk_mean`, one
    mean over the chunk: the trap)."""
    images, masks = s["arrs"]["images"], s["arrs"]["masks"]
    jfn, tfn = vgg_fns(narrow_vgg19())
    jb = jlg.resize_guidance(jnp.asarray(images), IMAGE, IMAGE, masks=jnp.asarray(masks))
    tb = lg.resize_guidance(torch.from_numpy(images), IMAGE, IMAGE, masks=torch.from_numpy(masks))
    j_lpips = lambda d, g, m: jfn(jnp.transpose(d, (2, 0, 1))[None], jnp.transpose(g, (2, 0, 1))[None])
    t_lpips = pvl.frame_lpips_fn(tfn)
    if chunk_mean:
        t_lpips = lambda d, g, m: tfn(d.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2))
    return (jlg.make_guidance_fn(jb, lpips_fn=j_lpips), lg.make_guidance_fn(tb, lpips_fn=t_lpips),
            jlg.make_guidance_fn(jb))


@pytest.fixture(scope="module")
def lpips_step(setup):  # noqa: F811
    """JAX's guided step with the per-frame VGG term, and its noise."""
    key = jax.random.key(5)
    jgf = guidance_fns(setup)[0]
    step = jax.jit(lambda x, k: jax_step(setup, jgf, jdg.GuidedSampleConfig(pair_mode="batched"), x, k)[0])
    jx = step(jnp.asarray(setup["arrs"]["x"]), key)
    return jx, torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], jx.shape)))


@pytest.mark.parametrize("chunk", [1, 5])
def test_guidance_lpips_term_matches_jax(setup, lpips_step, chunk):  # noqa: F811
    s = setup
    jgf, tgf, jgf_plain = guidance_fns(s)
    frames = np.random.default_rng(4).uniform(-1.1, 1.1, size=(T, IMAGE, IMAGE, 3)).astype(np.float32)
    want, plain = (np.array([float(fn(jnp.asarray(frames[f]), f)) for f in range(T)])
                   for fn in (jax.jit(lambda fr, f, g=g: g(fr, INDEX, f)[0]) for g in (jgf, jgf_plain)))

    def losses(fn):
        return np.concatenate([fn(torch.from_numpy(frames[c0:c0 + chunk]), INDEX,
                                  torch.arange(c0, min(c0 + chunk, T)))[0].numpy()
                               for c0 in range(0, T, chunk)])

    # each frame's loss with its own perceptual term (a few percent of the
    # loss); one mean over a 5-frame chunk is another loss
    np.testing.assert_allclose(losses(tgf), want, rtol=1e-5)
    assert (want - plain).min() > 0.01 * want.max()
    if chunk == 5:
        trap = losses(guidance_fns(s, chunk_mean=True)[1])
        assert not np.allclose(trap, want, rtol=1e-5, atol=0)

    # the step (without the term JAX's x_prev moves by 2.5e-4 of max |x_prev|)
    jx, noise = lpips_step
    x_prev, _, rho = dg.guided_step(s["tparams"], s["pm"], s["tsched"], s["tpr"], s["tcond"], s["tuncond"],
                                    dg.GuidedSampleConfig(decode_chunk=chunk), tgf, 1.0,
                                    torch.from_numpy(s["arrs"]["x"]), INDEX, noise)
    assert float(rho) > 0 and rel(x_prev, jx) <= 1e-4


def test_guided_steps_with_the_vgg_term_match_reference():
    """One mock event, then the 12 guided steps of
    test_torch_train_guided.py, each with a pseudo view, the VGG term at the
    trainer's default weight in both packages: the losses and every
    parameter within that test's tolerances, but the rest-SH coefficients
    within 1e-3 of their largest magnitude (2.3e-4 read). They start at 0
    and move only by Adam steps of 1.25e-4, so a gradient that differs by
    a fraction (the VGG's max-pools route the gradient of an exact tie to
    another element in each package) moves their max-relative error most."""
    cams = make_synthetic()
    jstate, gt_state, pts, cols = _states()
    K = _intrinsic(cams[0])
    jfn, tfn = vgg_fns(narrow_vgg19())
    jt = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(), FakeModelParams(),
        frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K, vgg_loss_fn=jfn)
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    pt = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), FakeModelParams(),
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=K, vgg_loss_fn=tfn)
    for tr in (jt, pt):
        tr.init_trajectory_pool()
        tr.run_diffusion_event(1)
    for g, w in zip(pt.pseudo_stack, jt.pseudo_stack):
        np.testing.assert_allclose(_np(g.pseudo_gt), _np(w.pseudo_gt), **COLOR_TOL)
    for it in STEPS:
        js, ps = jt.step(it), pt.step(it)
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
        jp, pp = float(jt.last_metrics["pseudo_l1"]), float(pt.last_metrics["pseudo_l1"])
        assert pp > 0.0 and abs(pp - jp) <= 1e-4, (it, pp, jp)
        assert float(pt.last_metrics["pseudo_vgg"]) > 0.0
    jfinal = jax.device_get(jt.state)
    act = np.asarray(jfinal.active)
    for name in PARAM_NAMES:
        want = np.asarray(getattr(jfinal.params, name))[act]
        got = getattr(pt.state.params, name).detach().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= (1e-3 if name == "features_rest" else 1e-4), (name, err)
    want = np.asarray(jfinal.xyz_gradient_accum)[act]
    err = np.abs(pt.state.xyz_gradient_accum.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
    np.testing.assert_array_equal(pt.state.denom.numpy(), np.asarray(jfinal.denom)[act])
