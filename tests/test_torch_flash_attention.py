"""Kernel L1's plain version and the attention dispatch, port against the
JAX package on the CPU.

`flash_attention_plain` (what the CPU path of `flash_attention` runs and
what the card's kernel is held to) against the JAX package's two forms of
the same function: `nnops._flash_attention_padded` with the library kernel
replaced by its pure-JAX `mha_reference` (as tests/test_fused_attention.py
does), at a ragged N = 1200 that the JAX wrapper pads to 1280; and the
einsum path of `nnops.attention`. Tolerances: float32 2e-6 (the same
products summed in another order); bfloat16 2e-2 (the weights are rounded
to bf16 before the second product, in another order in each package).
The JAX `mha_reference` keeps default matmul precision (3e-6 in f32).
L1's backward is tested in tests/test_torch_flash_attention_bwd.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import nnops as jnn
from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_plain_matches_padded_flash_wrapper_via_mha_reference(monkeypatch):
    import jax.experimental.pallas.ops.tpu.flash_attention as fmod

    def fake_kernel(q, k, v, segment_ids=None, sm_scale=1.0, block_sizes=None):
        return fmod.mha_reference(q, k, v, None, segment_ids, sm_scale=sm_scale)

    monkeypatch.setattr(fmod, "flash_attention", fake_kernel)
    arrs = qkv((2, 3, 1200, 64), 0)
    want = np.asarray(jnn._flash_attention_padded(*map(jnp.asarray, arrs), 0.125))
    got = fa.flash_attention_plain(*map(torch.from_numpy, arrs), 0.125).numpy()
    assert got.shape == want.shape == (2, 3, 1200, 64)
    np.testing.assert_allclose(got, want, atol=3e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 1100, 64), (1, 1, 1024, 512)])
def test_plain_matches_jax_attention(shape, dtype):
    arrs = qkv(shape, shape[2])
    scale = shape[3] ** -0.5
    want = np.asarray(jnn.attention(*(jnp.asarray(a, dtype) for a in arrs), scale), np.float32)
    got = fa.flash_attention_plain(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs), scale)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, qkv((1, 2, 300, 32), 3))
    assert torch.equal(fa.flash_attention(q, k, v, 0.2), fa.flash_attention_plain(q, k, v, 0.2))


def test_wrapper_is_forward_only():
    """Under autograd the wrapper's output carries L1's backward: an input
    that requires grad gets a finite gradient of its shape, and the output
    is the plain forward's."""
    q, k, v = map(torch.from_numpy, qkv((1, 1, 64, 32), 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, 0.2)
    assert torch.equal(out.detach(), fa.flash_attention_plain(q, k, v, 0.2))
    out.square().sum().backward()
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


def _spy(monkeypatch):
    calls = []
    real = nnops.flash_attention
    monkeypatch.setattr(nnops, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


@pytest.mark.parametrize("case", ["self_long", "self_short", "cross", "mask", "bias"])
def test_dispatch_rule(monkeypatch, case):
    """L1 takes unmasked, unbiased self-attention of N >= 1024; the rest
    takes the einsum form. Both agree with the JAX einsum path."""
    n = 1000 if case == "self_short" else 1024
    nk = 77 if case == "cross" else n
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, n, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, nk, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, nk, 16)).astype(np.float32)
    mask = rng.uniform(size=(1, 1, n, nk)) > 0.3 if case == "mask" else None
    bias = rng.standard_normal((1, 2, n, nk)).astype(np.float32) if case == "bias" else None
    calls = _spy(monkeypatch)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = nnops.attention(t(q), t(k), t(v), 0.25, bias=t(bias), mask=t(mask))
    assert len(calls) == (1 if case == "self_long" else 0)
    want = jnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                         bias=None if bias is None else jnp.asarray(bias),
                         mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_plain_flag_takes_the_plain_version(monkeypatch):
    calls = _spy(monkeypatch)
    q, k, v = map(torch.from_numpy, qkv((1, 1, 1024, 32), 6))
    with _build.plain_versions():
        out = nnops.attention(q, k, v, 0.2)
    assert not calls
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, 0.2))
