"""The scene-grounding guidance loss, port against the JAX package on the CPU.

`resize_guidance` (bilinear images, nearest masks and depths), the batched
guidance function of `make_guidance_fn` in l1, l2 and l2 + SSIM, with and
without masks and with an empty mask (each frame's loss, numel and
gradient against the JAX function called frame by frame), `ssim_noavg`
and `guidance_weight_schedule`. Tolerances: resized images 1e-5 absolute on
values in [0, 1] (two antialiased bilinear implementations); masks and
depths exact (the same source pixel); losses 1e-5 relative (float32 sums
over a frame); gradients 1e-5 of max |grad|, 5e-5 with the SSIM term
(its variances E[x^2] - mu^2 cancel, and each package blurs in another
order); the SSIM map 1e-5 absolute
(a 11x11 depthwise conv against JAX's banded matmuls); the schedule
1e-12 relative (the same numpy formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.guidance import loss_guidance as jlg
from guidedvd3dgs_tpu.utils import losses as jlosses
from guidedvd3dgs_tpu_torch.guidance import loss_guidance as lg
from guidedvd3dgs_tpu_torch.utils import losses

torch.set_num_threads(2)

T = 3


def guidance_inputs(h0, w0, seed, hole=True):
    """Images (T, 3, h0, w0) in [0, 1], observed masks with a rectangular
    hole, depths."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(T, 3, h0, w0)).astype(np.float32)
    masks = (rng.uniform(size=(T, 1, h0, w0)) > 0.2).astype(np.float32)
    if hole:
        masks[:, :, h0 // 4: h0 // 2, w0 // 3: 2 * w0 // 3] = 0.0
    depths = rng.uniform(0.5, 4.0, size=(T, 1, h0, w0)).astype(np.float32)
    return images, masks, depths


@pytest.mark.parametrize("src,dst", [((480, 640), (320, 448)), ((352, 624), (320, 448)),
                                     ((40, 40), (24, 60))])
def test_resize_guidance_matches_jax(src, dst):
    images, masks, depths = guidance_inputs(*src, seed=src[0])
    want = jlg.resize_guidance(jnp.asarray(images), *dst, masks=jnp.asarray(masks),
                               depths=jnp.asarray(depths))
    got = lg.resize_guidance(*map(torch.from_numpy, (images,)), *dst, masks=torch.from_numpy(masks),
                             depths=torch.from_numpy(depths))
    assert got.images.shape == (T, *dst, 3) and got.masks.shape == got.depths.shape == (T, *dst, 1)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images), atol=1e-5, rtol=0)
    assert float(got.images.min()) >= 0.0 and float(got.images.max()) <= 1.0
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(want.depths))


def test_torch_nearest_is_not_jax_nearest():
    """Why the masks take "nearest-exact": torch's "nearest" picks another
    source pixel than jax.image.resize's "nearest" at ~42% of the pixels of
    a random half-observed mask, 480x640 -> 320x448."""
    m = (np.random.default_rng(0).uniform(size=(3, 1, 480, 640)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m).transpose(0, 2, 3, 1), (3, 320, 448, 1), "nearest"))
    diff = {mode: float((torch.nn.functional.interpolate(torch.from_numpy(m), size=(320, 448), mode=mode)
                         .permute(0, 2, 3, 1).numpy() != want).mean())
            for mode in ("nearest", "nearest-exact")}
    assert diff["nearest-exact"] == 0.0
    assert 0.40 < diff["nearest"] < 0.45


def test_resize_guidance_without_masks():
    images, _, _ = guidance_inputs(48, 64, seed=1)
    got = lg.resize_guidance(torch.from_numpy(images), 32, 48)
    assert got.masks is None and got.depths is None
    want = jlg.resize_guidance(jnp.asarray(images), 32, 48)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("recon,ssim", [("l1", False), ("l2", False), ("l2", True)])
def test_guidance_fn_matches_jax(recon, ssim, with_mask):
    images, masks, depths = guidance_inputs(40, 56, seed=3)
    bufs_j = jlg.resize_guidance(jnp.asarray(images), 32, 48,
                                 masks=jnp.asarray(masks) if with_mask else None, depths=jnp.asarray(depths))
    bufs_t = lg.resize_guidance(torch.from_numpy(images), 32, 48,
                                masks=torch.from_numpy(masks) if with_mask else None,
                                depths=torch.from_numpy(depths))
    kw = dict(w_recon=0.5, ssim_guidance=ssim, recon_loss=recon)
    fj, ft = jlg.make_guidance_fn(bufs_j, **kw), lg.make_guidance_fn(bufs_t, **kw)
    frames = np.random.default_rng(4).uniform(-1.2, 1.2, size=(T, 32, 48, 3)).astype(np.float32)

    x = torch.from_numpy(frames).requires_grad_()
    loss, numel = ft(x, 7, torch.arange(T))
    (grad,) = torch.autograd.grad(loss.sum(), x)
    loss = loss.detach()
    gtol = 5e-5 if ssim else 1e-5
    assert loss.shape == numel.shape == (T,)
    for f in range(T):
        (lj, nj), gj = jax.value_and_grad(lambda d: fj(d, 7, f), has_aux=True)(jnp.asarray(frames[f]))
        np.testing.assert_allclose(float(loss[f]), float(lj), rtol=1e-5)
        assert float(numel[f]) == float(nj)
        gj = np.asarray(gj)
        assert np.abs(grad[f].numpy() - gj).max() <= gtol * np.abs(gj).max()


def test_guidance_fn_empty_mask_matches_jax():
    """A frame with no observed pixel: loss 0 and numel 0 in both packages
    (the sampler's division by that numel is tested in
    tests/test_torch_guided_sampler.py::test_empty_mask_frame: NaN in JAX,
    a zero gradient in the port)."""
    images, masks, _ = guidance_inputs(32, 48, seed=6)
    masks[1] = 0.0
    fj = jlg.make_guidance_fn(jlg.resize_guidance(jnp.asarray(images), 32, 48, masks=jnp.asarray(masks)))
    ft = lg.make_guidance_fn(lg.resize_guidance(torch.from_numpy(images), 32, 48, masks=torch.from_numpy(masks)))
    frames = np.random.default_rng(7).uniform(-1, 1, size=(T, 32, 48, 3)).astype(np.float32)
    loss, numel = ft(torch.from_numpy(frames), 0, torch.arange(T))
    lj, nj = fj(jnp.asarray(frames[1]), 0, 1)
    assert float(loss[1]) == float(lj) == 0.0 and float(numel[1]) == float(nj) == 0.0
    assert float(numel[0]) > 0


def test_guidance_fn_rejects_what_it_does_not_take():
    bufs = lg.resize_guidance(torch.zeros((1, 3, 8, 8)), 8, 8)
    with pytest.raises(ValueError):
        lg.make_guidance_fn(bufs, recon_loss="l3")


@pytest.mark.parametrize("with_mask", [True, False])
def test_ssim_noavg_matches_jax(with_mask):
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(size=(2, 3, 30, 44)).astype(np.float32) for _ in range(2))
    m = (rng.uniform(size=(2, 3, 30, 44)) > 0.3).astype(np.float32) if with_mask else None
    want = jlosses.ssim_noavg(jnp.asarray(a), jnp.asarray(b), mask=None if m is None else jnp.asarray(m))
    got = losses.ssim_noavg(torch.from_numpy(a), torch.from_numpy(b),
                            mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (2, 3, 30, 44)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # a (3, H, W) image takes the same map without its batch axis
    one = losses.ssim_noavg(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                            mask=None if m is None else torch.from_numpy(m[0]))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("step", [0, 1, 100, 1250, 2499, 2500, 4000])
def test_guidance_weight_schedule_matches_jax(step):
    want = jlg.guidance_weight_schedule(step)
    assert lg.guidance_weight_schedule(step) == pytest.approx(want, rel=1e-12)
    assert lg.guidance_weight_schedule(step, max_steps=300) == pytest.approx(
        jlg.guidance_weight_schedule(step, max_steps=300), rel=1e-12)
