"""Kernel L1's backward: its plain version and the autograd Function, port
against the JAX package on the CPU.

`flash_attention_bwd_plain` (what the CPU path of the `FlashAttention`
Function runs and what the card's dK/dV and dQ kernels are held to) from
the row log-sum-exp of `flash_attention_plain_lse`, against:
- torch autograd of `flash_attention_plain` (the same function
  differentiated by torch);
- `jax.vjp` of the JAX package's einsum attention (nnops.py:317-323);
- `jax.vjp` of `nnops._flash_attention_padded` with the library kernel
  replaced by its `mha_reference`, whose custom VJP is the library's own
  reference backward (flash_attention.py:1615), at a ragged N = 1200 that
  the JAX wrapper pads to 1280 (as tests/test_fused_attention.py does for
  the forward). That backward takes no scale, so the stand-in kernel
  multiplies q by it first.

Tolerances, max abs error over max |grad| of each of dq, dk, dv: float32
2e-5 (the softmax VJP against the Delta form, other sum orders); bfloat16
2e-2 (each package rounds dP, P or the products to bf16 at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.diffusion import nnops as jnn
from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def arrays(shape, seed):
    """q, k, v and the cotangent dO, unit normal."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def plain_grads(q, k, v, do, scale):
    out, lse = fa.flash_attention_plain_lse(q, k, v, scale)
    return fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale)


def assert_grads_close(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, f"{name}: max abs err / max |grad| {err:.3g} > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 1100, 64), (1, 1, 1024, 512)])
def test_bwd_plain_matches_autograd_of_plain(shape, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in arrays(shape, 1))
    scale = shape[3] ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*leaves, scale), leaves, do)
    got = plain_grads(q, k, v, do, scale)
    assert all(g.dtype == dt for g in got)
    assert_grads_close(got, [w.float() for w in want], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 1100, 64), (1, 1, 1024, 512)])
def test_bwd_plain_matches_jax_einsum_vjp(shape, dtype):
    arrs = arrays(shape, 2)
    scale = shape[3] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: jnn.attention(a, b, c, scale), jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]
    got = plain_grads(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs), scale)
    assert_grads_close(got, want, TOL[dtype])


def test_bwd_plain_matches_library_reference_vjp_ragged(monkeypatch):
    import jax.experimental.pallas.ops.tpu.flash_attention as fmod

    def fake_kernel(q, k, v, segment_ids=None, sm_scale=1.0, block_sizes=None):
        return fmod.mha_reference(q * sm_scale, k, v, None, segment_ids, sm_scale=1.0)

    monkeypatch.setattr(fmod, "flash_attention", fake_kernel)
    arrs = arrays((2, 3, 1200, 64), 3)
    _, vjp = jax.vjp(lambda a, b, c: jnn._flash_attention_padded(a, b, c, 0.125),
                     *map(jnp.asarray, arrs[:3]))
    want = vjp(jnp.asarray(arrs[3]))
    got = plain_grads(*map(torch.from_numpy, arrs), 0.125)
    assert_grads_close(got, want, TOL["float32"])


def test_plain_lse_matches_library_residuals():
    """The plain forward's log-sum-exp against m + log(l), the residuals the
    library reference keeps for its backward, at N = 1200 (no pad)."""
    import jax.experimental.pallas.ops.tpu.flash_attention as fmod

    q, k, v, _ = arrays((1, 2, 1200, 64), 4)
    _, l, m = fmod.mha_reference_no_custom_vjp(
        jnp.asarray(q) * 0.125, jnp.asarray(k), jnp.asarray(v), None, None, save_residuals=True)
    want = np.asarray(m) + np.log(np.asarray(l))
    _, lse = fa.flash_attention_plain_lse(*map(torch.from_numpy, (q, k, v)), 0.125)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 1200)
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("plain", [False, True])
def test_function_on_cpu(plain):
    """Under autograd the wrapper (and `nnops.attention` inside
    `plain_versions()`, the plain pair) runs the plain forward and the
    plain backward on CPU tensors: the same output as without autograd,
    and flash_attention_bwd_plain's gradients exactly."""
    q, k, v, do = map(torch.from_numpy, arrays((1, 2, 1024, 32), 5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if plain:
        with _build.plain_versions():
            out = nnops.attention(*leaves, 0.2)
    else:
        out = fa.flash_attention(*leaves, 0.2)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), fa.flash_attention_plain(q, k, v, 0.2))
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, plain_grads(q, k, v, do, 0.2)):
        assert torch.equal(g, w)
