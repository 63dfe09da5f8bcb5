"""Kernel N1 (GroupNorm + SiLU, csrc/group_norm.cu) against its plain
version on the card.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. Forward: the output
within `fwd_tol` of the plain bf16 fold (tests/group_norm_tol.py: one
bf16 ulp, the fold's cancellation, and with SiLU the plain version's
second rounding), mean and rstd within 1e-5 relative of float64
statistics of the same input (2 f32 ulps of the mean where |mean| / std is
1000). Backward: dx within `bwd_tol` of autograd through the plain
version on the float32 copy of the same input. Two runs give the same
bits. Under autograd the
kernel saves x, mean and rstd: 2 bytes an element where the fold held its
f32 copy and SiLU's input, 6. Run on the card without the reference
package's conftest (it imports JAX):

    python -m pytest tests/test_torch_cuda_group_norm.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from group_norm_tol import bwd_tol, fwd_tol
from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda

GROUPS = 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def inputs(dev, shape, loc=0.0, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x, w, b, dy = (torch.from_numpy(rng.normal(m, sd, sh).astype(np.float32)).to(dev, torch.bfloat16)
                   for m, sd, sh in ((loc, scale, shape), (1.0, 0.5, c), (0.0, 0.5, c), (0.0, 1.0, shape)))
    return x, w, b, dy


def scale_of(x, w, rstd):
    c = x.shape[-1]
    return (rstd[:, torch.arange(c, device=x.device) // (c // GROUPS)] * w.float())[:, None]


# (shape, loc, scale, eps): C/G of 4, 10, 20 and 40; 4D and 5D; P not a
# multiple of the chunk; the cancellation case N(100, 0.1); the UNet's
# temporal stack (one sample, S past 32 partials) and the VAE's last level
CASES = [
    ((3, 17, 23, 128), 0.0, 1.0, 1e-6),
    ((3, 17, 23, 320), 0.0, 1.0, 1e-5),
    ((2, 3, 9, 11, 640), 0.0, 2.0, 1e-6),
    ((2, 3, 9, 11, 1280), 0.0, 1.0, 1e-5),
    ((4, 13, 7, 320), 100.0, 0.1, 1e-6),
    ((2, 5, 6, 7, 640), 100.0, 0.1, 1e-5),
    ((1, 25, 40, 56, 320), 0.0, 1.0, 1e-5),
    ((5, 320, 448, 128), 0.0, 1.0, 1e-6),
]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,loc,scale,eps", CASES)
def test_fwd_matches_plain(dev, shape, loc, scale, eps, silu):
    x, w, b, _ = inputs(dev, shape, loc, scale)
    before = _build.LAUNCHES["group_norm_fwd"]
    y, (mean, rstd) = gn._forward(*gn.prepare(x, w, b, GROUPS), GROUPS, eps, silu)
    assert _build.LAUNCHES["group_norm_fwd"] == before + 1
    want = gn.group_norm_plain(x, w, b, GROUPS, eps, silu)
    pre = gn.group_norm_plain(x, w, b, GROUPS, eps)
    n, c = shape[0], shape[-1]
    x3, y3, want3, pre3 = (t.reshape(n, -1, c) for t in (x, y, want, pre))
    err = (y3.float() - want3.float()).abs()
    assert (err <= fwd_tol(want3, pre3, x3, scale_of(x3, w, rstd), silu)).all(), float(err.max())
    xg = x3.double().reshape(n, -1, GROUPS, c // GROUPS)
    var, m = torch.var_mean(xg, dim=(1, 3), correction=0)
    mean_tol = 2 * 7.63e-6 if loc else 1e-5 * float(m.abs().max() + var.sqrt().max())
    assert float((mean.double() - m).abs().max()) <= mean_tol
    r = torch.rsqrt(var + eps)
    assert float(((rstd.double() - r) / r).abs().max()) <= (1e-4 if loc else 1e-5)


@pytest.mark.parametrize("silu", [False, True])
def test_f32_weights_read_as_bf16_ones(dev, silu):
    """f32 weight and bias are taken in x's dtype, as every layer of nnops
    takes its weight: the bf16 ones' bits, forward and backward."""
    x, w, b, dy = inputs(dev, (3, 17, 23, 320), seed=4)
    w32 = w.float() + torch.randn_like(w.float()) * 1e-3  # between bf16 values
    b32 = b.float() + torch.randn_like(b.float()) * 1e-3
    outs = []
    for ww, bb in ((w32.bfloat16(), b32.bfloat16()), (w32, b32)):
        xg = x.detach().requires_grad_()
        y = gn.group_norm(xg, ww, bb, GROUPS, 1e-5, silu)
        outs.append((y, torch.autograd.grad(y, xg, dy)[0]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,loc,scale,eps", CASES)
def test_bwd_matches_autograd(dev, shape, loc, scale, eps, silu):
    x, w, b, dy = inputs(dev, shape, loc, scale, seed=1)
    xg = x.detach().requires_grad_()
    before = _build.LAUNCHES["group_norm_bwd"]
    (dx,) = torch.autograd.grad(gn.group_norm(xg, w, b, GROUPS, eps, silu), xg, dy)
    assert _build.LAUNCHES["group_norm_bwd"] == before + 1
    xf = x.float().requires_grad_()
    (want,) = torch.autograd.grad(gn.group_norm_plain(xf, w, b, GROUPS, eps, silu), xf, dy.float())
    assert dx.dtype == x.dtype
    err = (dx.float() - want).abs()
    assert (err <= bwd_tol(want)).all(), float(err.max() / want.abs().max())


@pytest.mark.parametrize("silu", [False, True])
def test_bitwise_repeatable(dev, silu):
    x, w, b, dy = inputs(dev, (5, 80, 112, 256), seed=2)
    outs = []
    for _ in range(2):
        xg = x.detach().requires_grad_()
        y = gn.group_norm(xg, w, b, GROUPS, 1e-6, silu)
        (dx,) = torch.autograd.grad(y, xg, dy)
        outs.append((y, dx))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def saved_bytes(fn, x):
    """Bytes of the distinct storages autograd saves for fn(x)'s backward."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(seen.values())


@pytest.mark.parametrize("silu", [False, True])
def test_saved_bytes_fall(dev, silu):
    """A branch's level-0 input (25 frames of 40x56x320): the fold saves
    its f32 copy (4 bytes an element) and, with SiLU, SiLU's bf16 input (2);
    the kernel saves x (2) and the (N, G) statistics: 4 bytes an element
    less with SiLU, 2 without."""
    x, w, b, _ = inputs(dev, (25, 40, 56, 320))
    x = x.requires_grad_()
    n = x.numel()
    kernel = saved_bytes(lambda t: gn.group_norm(t, w, b, GROUPS, 1e-5, silu), x)
    plain = saved_bytes(lambda t: gn.group_norm_plain(t, w, b, GROUPS, 1e-5, silu), x)
    assert kernel <= 2 * n + 2 ** 20
    assert plain - kernel >= (4 if silu else 2) * n - 2 ** 20


def test_nnops_dispatch_on_the_card(dev):
    """bf16 under autograd takes the kernels (one forward and one backward
    launch), also from a view off the 16-byte boundary and a transposed
    one (copied first); f32 and a weight that needs grad take the plain
    fold."""
    x, w, b, dy = inputs(dev, (2, 3, 9, 11, 640), seed=3)
    p = {"n.weight": w, "n.bias": b}
    start = dict(_build.LAUNCHES)
    xg = x.detach().requires_grad_()
    (dx,) = torch.autograd.grad(nnops.group_norm(p, "n", xg, GROUPS, 1e-6, silu=True), xg, dy)
    assert _build.LAUNCHES["group_norm_fwd"] == start["group_norm_fwd"] + 1
    assert _build.LAUNCHES["group_norm_bwd"] == start["group_norm_bwd"] + 1
    nnops.group_norm(p, "n", x.float(), GROUPS, 1e-6, silu=True)
    pg = {"n.weight": w.clone().requires_grad_(), "n.bias": b}
    nnops.group_norm(pg, "n", xg, GROUPS, 1e-6, silu=True).sum().backward()
    assert _build.LAUNCHES["group_norm_fwd"] == start["group_norm_fwd"] + 1
    assert _build.LAUNCHES["group_norm_bwd"] == start["group_norm_bwd"] + 1
    y = nnops.group_norm(p, "n", x, GROUPS, 1e-6, silu=True)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)  # 2 bytes in
    shifted.copy_(x)
    xt = x.transpose(2, 3).contiguous().transpose(2, 3)
    for v in (shifted, xt):
        vg = v.detach().requires_grad_()
        got = nnops.group_norm(p, "n", vg, GROUPS, 1e-6, silu=True)
        assert torch.equal(got, y) and torch.equal(torch.autograd.grad(got, vg, dy)[0], dx)
    assert _build.LAUNCHES["group_norm_fwd"] == start["group_norm_fwd"] + 4
    assert _build.LAUNCHES["group_norm_bwd"] == start["group_norm_bwd"] + 3


def test_rejects_what_it_does_not_take(dev):
    """What the kernels cannot take raises, on the card, rather than taking
    the plain fold: f32 activations, C not a multiple of 8 or of the
    groups, a weight of another length; and a dy off the 16-byte boundary
    is copied, not read misaligned."""
    x, w, b, dy = inputs(dev, (2, 6, 5, 64))
    for args in ((x.float(), w, b, 8), (x[..., :60], w[:60], b[:60], 4), (x, w, b, 6), (x, w[:32], b, 8)):
        with pytest.raises(ValueError):
            gn.group_norm(*args, 1e-6, False)
    xk, wk, bk = gn.prepare(x, w, b, 8)
    _, stats = gn._forward(xk, wk, bk, 8, 1e-6, True)
    shifted = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=dev)[1:].view(dy.shape)
    shifted.copy_(dy)
    want = gn._backward(dy, xk, wk, bk, stats, 8, True)
    assert torch.equal(gn._backward(shifted, xk, wk, bk, stats, 8, True), want)
