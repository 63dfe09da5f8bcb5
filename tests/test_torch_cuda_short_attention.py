"""Kernel L2 (short and cross attention at D = 64, csrc/short_attn.cu)
against its plain version on the card.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. Forward: the output
within L1's bf16 tolerance of the einsum form on the same bf16 inputs (1e-2
on unit-normal inputs, relative above 1: with 25 keys or fewer outputs
reach 2-4, where one bf16 ulp is 1.6e-2), the row log-sum-exp within 1e-4 of
torch.logsumexp of the f32 logits. Backward: dq, dk, dv within 2e-2 of
max |grad| (L1's; at least 1e-3) of L1's plain backward (f32 products from the same
output and log-sum-exp): the kernel rounds dS to bf16 for two of its
products. q, k, v are `split_heads` views, as the UNets pass them; the
output reshapes through `merge_heads` without a copy; two runs give the
same bits. Run on the card without the reference package's conftest (it
imports JAX):

    python -m pytest tests/test_torch_cuda_short_attention.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch

from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import flash_attention as fa
from guidedvd3dgs_tpu_torch.ops import short_attention as sa

pytestmark = pytest.mark.cuda

FWD_TOL, LSE_TOL, BWD_TOL = 1e-2, 1e-4, 2e-2

# (batch, heads, Lq, Lk): the temporal self-attention (25 frames), the
# cross-attention (77 text, 16 image tokens, SVD's 1), the spatial
# self-attention at levels 1-3 of both engine widths, and ragged shapes
# (an odd problem count, rows and keys past a tile, one key past 128)
CASES = [(448, 5, 25, 25), (2, 5, 560, 77), (3, 5, 140, 16), (64, 5, 25, 1), (4, 10, 560, 560),
         (2, 10, 640, 640), (3, 20, 140, 140), (5, 20, 35, 35), (3, 20, 40, 40), (3, 3, 17, 17),
         (1, 3, 33, 129), (7, 1, 200, 200), (1, 1, 1000, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def heads(dev, b, h, n, seed):
    """A (b, h, n, 64) bf16 `split_heads` view of unit-normal rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return nnops.split_heads(torch.randn((b, n, h * 64), generator=g, device=dev).to(torch.bfloat16), h)


def rel_err(got, want):
    """max |got - want| over max |want|, at least 1e-3: with one key dq is
    0 up to rounding."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-3))


@pytest.mark.parametrize("b,h,lq,lk", CASES)
def test_forward_and_lse(dev, b, h, lq, lk):
    q, k, v = heads(dev, b, h, lq, 1), heads(dev, b, h, lk, 2), heads(dev, b, h, lk, 3)
    scale = 64 ** -0.5
    with torch.no_grad():
        out, lse = sa._forward(q, k, v, scale, with_lse=True)
        again = sa.short_attention(q, k, v, scale)
    want = sa.attention_plain(q, k, v, scale)
    want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert bool(((out.float() - want.float()).abs() <= FWD_TOL * want.float().abs().clamp(min=1.0)).all())
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    assert torch.equal(out, again)
    merged = nnops.merge_heads(out)
    assert merged.data_ptr() == out.data_ptr()  # no copy


@pytest.mark.parametrize("b,h,lq,lk", CASES)
def test_backward(dev, b, h, lq, lk):
    q, k, v, do = heads(dev, b, h, lq, 4), heads(dev, b, h, lk, 5), heads(dev, b, h, lk, 6), heads(dev, b, h, lq, 7)
    scale = 64 ** -0.5
    self_attn = lq == lk
    leaves = [t.detach().requires_grad_(want) for t, want in ((q, True), (k, self_attn), (v, self_attn))]
    before = dict(_build.LAUNCHES)
    out = nnops.attention(*leaves, scale)
    grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], do)
    ran = [_build.LAUNCHES[n] - before[n] for n in ("short_attn_fwd", "short_attn_bwd", "flash_attn_fwd")]
    assert ran == [1, 1, 0]
    with torch.no_grad():
        o, lse = sa._forward(q, k, v, scale, with_lse=True)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o)
    for got, w in zip(grads, want):
        assert got.shape == w.shape and got.dtype == torch.bfloat16
        assert rel_err(got, w) <= BWD_TOL
    again = torch.autograd.grad(nnops.attention(*leaves, scale), [t for t in leaves if t.requires_grad], do)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


def test_contiguous_and_misaligned_inputs(dev):
    """Contiguous (B, H, N, D) inputs and a view one element off a 16-byte
    boundary (copied by the wrapper) give the same output as the views."""
    q, k, v = heads(dev, 6, 5, 25, 8), heads(dev, 6, 5, 25, 9), heads(dev, 6, 5, 25, 10)
    scale = 0.125
    with torch.no_grad():
        want = sa.short_attention(q, k, v, scale)
        assert torch.equal(sa.short_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale), want)
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        off = buf[1:].view(q.shape).copy_(q)
        assert torch.equal(sa.short_attention(off, k, v, scale), want)


def test_routing_on_the_card(dev):
    """What nnops.attention sends where, by launches: L2 for bf16 D = 64 of
    any length below L1's; the einsum form for f32, a mask, a bias, D = 80,
    and cross-attention whose k needs a gradient (refused by the kernel's
    own entry too)."""
    q, k = heads(dev, 2, 2, 40, 11), heads(dev, 2, 2, 7, 12)
    scale = 0.125

    def launches(*args, **kw):
        before = _build.LAUNCHES["short_attn_fwd"]
        nnops.attention(*args, scale, **kw)
        return _build.LAUNCHES["short_attn_fwd"] - before

    with torch.no_grad():
        assert launches(q, k, k) == 1
        assert launches(q.float(), k.float(), k.float()) == 0
        assert launches(q, k, k, mask=torch.ones((2, 2, 40, 7), dtype=torch.bool, device=dev)) == 0
        assert launches(q, k, k, bias=torch.zeros((40, 7), device=dev)) == 0
        q80 = torch.randn((1, 1, 40, 80), device=dev).to(torch.bfloat16)
        assert launches(q80, q80, q80) == 0
        with _build.plain_versions():
            assert launches(q, k, k) == 0
    kg = k.detach().requires_grad_()
    assert launches(q, kg, kg) == 0
    with pytest.raises(ValueError):
        sa.short_attention(q, kg, kg, scale)
