"""The diffusion primitives, port against the JAX package on the CPU.

Same numpy-seeded inputs and parameters through `guidedvd3dgs_tpu.
diffusion.nnops` and `guidedvd3dgs_tpu_torch.diffusion.nnops`. Tolerances:
float32 1e-5 absolute on O(1) outputs (other summation orders); bfloat16
two bf16 ulps (JAX's bf16 layer_norm rounds its intermediate steps, the
port's rounds once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import nnops as jnn
from guidedvd3dgs_tpu_torch.diffusion import nnops

torch.set_num_threads(2)


def rnd(rng, *shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


def both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()})


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def group_norm_f64(x, w, b, groups, eps):
    xg = x.astype(np.float64).reshape(x.shape[:-1] + (groups, -1))
    red = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    y = (xg - xg.mean(axis=red, keepdims=True)) / np.sqrt(xg.var(axis=red, keepdims=True) + eps)
    return y.reshape(x.shape) * w + b


@pytest.mark.parametrize("shape", [(2, 6, 5, 64), (1, 3, 4, 5, 64)])
@pytest.mark.parametrize("dtype,loc,scale", [("float32", 0.0, 1.0), ("bfloat16", 0.0, 1.0),
                                             ("float32", 100.0, 0.1), ("bfloat16", 100.0, 0.1)])
def test_group_norm(shape, dtype, loc, scale):
    """Both JAX forms: two-pass f32, and the folded x*scale + shift for
    half precision. N(100, 0.1) is the cancellation hazard of the folded
    form (ROADMAP queue 3). There |mean|/std = 1000 turns the f32 rounding
    of the mean (ulp 7.6e-6) into ~1e-4 of the normalised output, so in
    f32 each package is held to the float64 result within 1e-3 and to the
    other within 1e-3. In bf16 both take the same fold and agree within
    one bf16 ulp; both are 0.03 from the float64 result of the rounded
    input (the fold's cancellation, shared by design)."""
    rng = np.random.default_rng(0)
    x = rnd(rng, *shape, scale=scale, loc=loc)
    p = {"n.weight": rnd(rng, 64, scale=0.5, loc=1.0), "n.bias": rnd(rng, 64, scale=0.5)}
    jp, tp = both(p)
    want = jnn.group_norm(jp, "n", jnp.asarray(x, dtype), num_groups=8, eps=1e-6)
    got = nnops.group_norm(tp, "n", torch.from_numpy(x).to(getattr(torch, dtype)), num_groups=8, eps=1e-6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        atol = 1e-5 if loc == 0.0 else 1e-3
        truth = group_norm_f64(x, p["n.weight"], p["n.bias"], 8, 1e-6)
        close(got, truth, atol + 1e-5)
        close(got, want, atol)
    else:
        close(got, want, 3e-2)  # outputs reach |4|: one bf16 ulp is 1.6e-2 there


def test_layer_norm_and_linear():
    rng = np.random.default_rng(1)
    x = rnd(rng, 3, 7, 48)
    p = {"ln.weight": rnd(rng, 48), "ln.bias": rnd(rng, 48), "fc.weight": rnd(rng, 24, 48),
         "fc.bias": rnd(rng, 24), "nb.weight": rnd(rng, 24, 48)}
    jp, tp = both(p)
    close(nnops.layer_norm(tp, "ln", torch.from_numpy(x)), jnn.layer_norm(jp, "ln", jnp.asarray(x)), 1e-5)
    close(nnops.linear(tp, "fc", torch.from_numpy(x)), jnn.linear(jp, "fc", jnp.asarray(x)), 1e-5)
    close(nnops.linear(tp, "nb", torch.from_numpy(x)), jnn.linear(jp, "nb", jnp.asarray(x)), 1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    close(nnops.layer_norm(tp, "ln", torch.from_numpy(x).bfloat16()), jnn.layer_norm(jp, "ln", xb),
          1e-2, rtol=2 ** -6)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0), (2, ((0, 1), (0, 1)))])
def test_conv2d(stride, padding):
    rng = np.random.default_rng(2)
    x = rnd(rng, 2, 9, 10, 16)
    k = 1 if padding == 0 else 3
    p = {"c.weight": rnd(rng, 8, 16, k, k, scale=0.2), "c.bias": rnd(rng, 8)}
    jp, tp = both(p)
    jx = jnp.asarray(x)
    if isinstance(padding, tuple):  # the VAE's asymmetric downsample: pad, then a VALID conv
        jx, jpad = jnp.pad(jx, ((0, 0), (0, 1), (0, 1), (0, 0))), 0
    else:
        jpad = padding
    want = jnn.conv2d(jp, "c", jx, stride=stride, padding=jpad)
    got = nnops.conv2d(tp, "c", torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape == want.shape
    close(got, want, 1e-5)


def test_conv3d_and_conv1d():
    rng = np.random.default_rng(3)
    x = rnd(rng, 2, 5, 4, 3, 16)
    p = {"t.weight": rnd(rng, 16, 16, 3, 1, 1, scale=0.2), "t.bias": rnd(rng, 16),
         "k1.weight": rnd(rng, 24, 16, 1), "k1.bias": rnd(rng, 24)}
    jp, tp = both(p)
    close(nnops.conv3d(tp, "t", torch.from_numpy(x)), jnn.conv3d(jp, "t", jnp.asarray(x)), 1e-5)
    close(nnops.conv1d_k1(tp, "k1", torch.from_numpy(x)), jnn.conv1d_k1(jp, "k1", jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    ts = np.array([0, 1, 17, 999], np.int32)
    want = jnn.timestep_embedding(jnp.asarray(ts), dim)
    got = nnops.timestep_embedding(torch.from_numpy(ts), dim)
    # sin/cos of arguments up to 999 rad: the f32 arguments agree, libm differs by ulps
    close(got, want, 2e-5)


def test_resampling_and_activations():
    rng = np.random.default_rng(4)
    x = rnd(rng, 2, 3, 7, 9, 4)
    close(nnops.upsample_nearest_2x(torch.from_numpy(x)), jnn.upsample_nearest_2x(jnp.asarray(x)), 0)
    close(nnops.avg_pool_2x(torch.from_numpy(x)), jnn.avg_pool_2x(jnp.asarray(x)), 1e-6)
    close(nnops.gelu(torch.from_numpy(x)), jnn.gelu(jnp.asarray(x)), 1e-6)
    close(nnops.silu(torch.from_numpy(x)), jnn.silu(jnp.asarray(x)), 1e-6)
    h = torch.from_numpy(rnd(rng, 2, 5, 24))
    assert torch.equal(nnops.merge_heads(nnops.split_heads(h, 3)), h)
    np.testing.assert_array_equal(nnops.split_heads(h, 3).numpy(),
                                  np.asarray(jnn.split_heads(jnp.asarray(h.numpy()), 3)))
