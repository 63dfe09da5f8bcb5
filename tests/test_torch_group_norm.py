"""Kernel N1 (GroupNorm + SiLU) on the CPU: which calls take the kernels,
the launch shapes the host picks, and the kernels' arithmetic.

The CUDA kernels run only on the card (tests/test_torch_cuda_group_norm.py).
Here `emulate_fwd` / `emulate_bwd` repeat csrc/group_norm.cu's algorithm in
f32 torch ops on the launch shape `geometry` picks (Welford's update over
each row slot's rows, Chan's merges of slots, channels and chunks, the
fold with one rounding, the backward's group sums and dx), and are held
to the plain fold forward by `fwd_tol` (tests/group_norm_tol.py) and to
float64 autograd through it backward (within 1e-5 of max |dx|: f32 sums;
1e-3 where |mean| / std is 1000, whose f32 mean carries a relative 1e-5
into x - mean).
"""

import types

import numpy as np
import pytest
import torch

from group_norm_tol import fwd_tol
from guidedvd3dgs_tpu_torch.diffusion import nnops
from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops import group_norm as gn

torch.set_num_threads(2)

# (N, P, C) of the UNet at 320x448 latents (level 0 to 3, the output
# blocks' concatenations, the temporal stacks' (B, T*H*W)) and of the VAE
# decoder (5 frames a chunk, 512 channels at 40x56 up to 128 at 320x448)
MODEL_SHAPES = [(50, 2240, 320), (2, 56000, 320), (50, 560, 640), (50, 140, 1280), (50, 35, 1280),
                (50, 35, 2560), (50, 140, 1920), (50, 560, 960), (1, 56000, 320), (5, 2240, 512),
                (5, 35840, 512), (5, 35840, 256), (5, 143360, 256), (5, 143360, 128)]


@pytest.mark.parametrize("n,p,c", MODEL_SHAPES)
def test_geometry_covers_each_sample(n, p, c):
    threads, chunk, s = gn.geometry(n, p, c, 132, gn.BLOCKS_PER_SM)
    vpr = c // gn.VEC
    r = threads // vpr
    assert threads % 32 == 0 and threads % vpr == 0 and gn.MIN_THREADS <= threads <= gn.MAX_THREADS
    assert chunk % r == 0 and s * chunk >= p and (s - 1) * chunk < p
    assert s * n <= 2 * gn.BLOCKS_PER_SM * 132 or chunk == r  # about the target, or one step a chunk
    assert gn.threads_for(c) == threads


def fake_cuda(shape, dtype):
    """What takes_kernel reads of a CUDA activation, for a host without one."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=torch.Size(shape))


def param(device, c, dtype, grad=False):
    """A weight or bias as takes_kernel reads it: a CPU tensor, or a stand-in
    for one on a card."""
    if device == "cpu":
        return torch.ones(c, dtype=dtype, requires_grad=grad)
    return types.SimpleNamespace(requires_grad=grad)


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("device,dtype,pdtype,grad,shape,takes", [
    ("cuda", BF, BF, "", (2, 6, 5, 64), True),
    ("cuda", F16, F16, "", (2, 6, 5, 64), False),
    ("cuda", BF, F32, "", (2, 6, 5, 64), True),
    ("cuda", BF, BF, "", (2, 3, 4, 5, 64), True),
    ("cpu", BF, BF, "", (2, 6, 5, 64), False),
    ("cuda", F32, F32, "", (2, 6, 5, 64), False),
    ("cuda", BF, BF, "weight", (2, 6, 5, 64), False),
    ("cuda", BF, BF, "bias", (2, 6, 5, 64), False),
    ("cuda", BF, BF, "", (2, 6, 5, 12), True),    # not a multiple of 8 channels: `prepare` raises
    ("cpu", F32, F32, "", (2, 6, 5, 64), False),
    ("cuda", BF, BF, "", (2, 6, 5, 8200), True),  # no block shape: `prepare` raises
    ("cpu", BF, BF, "weight", (2, 6, 5, 64), False),
])
def test_dispatch(device, dtype, pdtype, grad, shape, takes):
    """The kernels take CUDA bf16 activations whose weight and bias need no
    gradient, whatever else the call shows (the weight's dtype, C: what
    they cannot take `prepare` refuses with an error, never the plain
    fold); CPU, f16, f32 and grad-requiring weights go to the plain fold."""
    x = torch.zeros(shape, dtype=dtype) if device == "cpu" else fake_cuda(shape, dtype)
    c = shape[-1]
    w = param(device, c, pdtype, grad == "weight")
    b = param(device, c, pdtype, grad == "bias")
    assert gn.takes_kernel(x, w, b) is takes


def test_dispatch_inside_plain_versions():
    """Inside `plain_versions()` the kernels take nothing, and outside it
    again what they took before."""
    x, w, b = fake_cuda((2, 6, 5, 64), BF), param("cuda", 64, BF), param("cuda", 64, BF)
    with _build.plain_versions():
        assert not gn.takes_kernel(x, w, b)
    assert gn.takes_kernel(x, w, b)


@pytest.mark.parametrize("how", ["aligned", "offset", "strided"])
def test_aligned_copies_only_what_the_loads_cannot_read(how):
    """`aligned` (the kernels' x and dy) returns a contiguous tensor at a
    16-byte boundary with the same values: the tensor itself where it is
    one, else a copy."""
    base = torch.arange(2 * 6 * 5 * 64 + 8, dtype=torch.float32).bfloat16()
    if how == "aligned":
        t = base[:-8].view(2, 6, 5, 64)
    elif how == "offset":
        t = base[1:-7].view(2, 6, 5, 64)  # 2 bytes past the boundary
    else:
        t = base[:-8].view(2, 5, 6, 64).transpose(1, 2)
    assert (base.data_ptr() % 16 == 0) and (t.data_ptr() % 16 == 0) == (how != "offset")
    got = gn.aligned(t)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, t)
    assert (got.data_ptr() == t.data_ptr()) is (how == "aligned")


def test_nnops_cpu_takes_the_plain_fold(monkeypatch):
    """On the CPU, bf16 and f32 calls never reach the kernels, and nnops'
    result is the plain version's, SiLU included."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel path ran on the CPU")

    monkeypatch.setattr(gn, "group_norm", no_kernel)
    rng = np.random.default_rng(5)
    p = {"n.weight": torch.from_numpy(rng.normal(1.0, 0.5, 64).astype(np.float32)).bfloat16(),
         "n.bias": torch.from_numpy(rng.normal(0.0, 0.5, 64).astype(np.float32)).bfloat16()}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(2, 3, 4, 5, 64)).astype(np.float32)).to(dtype)
        for silu in (False, True):
            got = nnops.group_norm(p, "n", x, num_groups=8, eps=1e-6, silu=silu)
            assert torch.equal(got, gn.group_norm_plain(x, p["n.weight"], p["n.bias"], 8, 1e-6, silu))


# --- the kernels' arithmetic, op by op in f32 -------------------------------

def chan(a, b):
    """csrc/group_norm.cu::chan_merge of (count, mean, m2) triples (counts
    python numbers or tensors, equal across the batch)."""
    (na, ma, qa), (nb, mb, qb) = a, b
    if nb == 0:
        return a
    if na == 0:
        return b
    nn = na + nb
    d = mb - ma
    fb = torch.tensor(nb, dtype=torch.float32) / torch.tensor(nn, dtype=torch.float32)
    return nn, ma + d * fb, qa + qb + d * d * torch.tensor(float(na)) * fb


def fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def shape_of(x, sms):
    n, p, c = x.shape
    threads, chunk, s = gn.geometry(n, p, c, sms, gn.BLOCKS_PER_SM)
    return threads // (c // gn.VEC), chunk, s


def emulate_fwd(x, w, b, groups, eps, silu, sms):
    """x (N, P, C) f32 holding bf16 values -> (y f32 before rounding, mean, rstd)."""
    n, p, c = x.shape
    r, chunk, s = shape_of(x, sms)
    cg = c // groups
    parts = []
    for q in range(s):
        rows = x[:, q * chunk:min((q + 1) * chunk, p)]
        nr = rows.shape[1]
        slot = (0, torch.zeros(n, c), torch.zeros(n, c))
        for j in range(r):
            mean, m2 = torch.zeros(n, c), torch.zeros(n, c)
            for k, i in enumerate(range(j, nr, r)):
                d = rows[:, i] - mean
                mean = mean + d * (1.0 / torch.tensor(k + 1.0))
                m2 = m2 + d * (rows[:, i] - mean)
            slot = chan(slot, (len(range(j, nr, r)), mean, m2))
        grp = []
        for g in range(groups):
            acc = (0, None, None)
            for ch in range(g * cg, (g + 1) * cg):
                acc = chan(acc, (nr, slot[1][:, ch], slot[2][:, ch]))
            grp.append((nr * cg, acc[1], acc[2]))
        parts.append(grp)
    mean, rstd = torch.zeros(n, groups), torch.zeros(n, groups)
    for g in range(groups):
        acc = (0, None, None)
        for q in range(s):
            acc = chan(acc, parts[q][g])
        mean[:, g], rstd[:, g] = acc[1], torch.rsqrt(acc[2] / float(acc[0]) + eps)
    chg = torch.arange(c) // cg
    scale = rstd[:, chg] * w
    shift = b - mean[:, chg] * scale
    pre = fma32(x, scale[:, None], shift[:, None])
    return (pre / (1.0 + torch.exp(-pre)) if silu else pre), mean, rstd


def emulate_bwd(dy, x, w, b, mean, rstd, groups, silu, sms):
    n, p, c = x.shape
    _, chunk, s = shape_of(x, sms)
    cg = c // groups
    chg = torch.arange(c) // cg
    mu, rs = mean[:, chg][:, None], rstd[:, chg][:, None]
    scale = rs * w
    pre = fma32(x, scale, b - mu * scale)
    if silu:
        sg = 1.0 / (1.0 + torch.exp(-pre))
        gg = dy * (sg * (1.0 + pre * (1.0 - sg)))
    else:
        gg = dy
    d = x - mu
    s1, s2 = torch.zeros(n, groups), torch.zeros(n, groups)
    for q in range(s):
        sl = slice(q * chunk, min((q + 1) * chunk, p))
        a = (gg[:, sl].sum(1) * w).reshape(n, groups, cg).sum(-1)
        bb = ((gg[:, sl] * d[:, sl]).sum(1) * rs[:, 0] * w).reshape(n, groups, cg).sum(-1)
        s1, s2 = s1 + a, s2 + bb
    cnt = float(p * cg)
    k1 = rs * (s1 / cnt)[:, chg][:, None]
    k2 = rs * (rs * (s2 / cnt)[:, chg][:, None])
    return scale * gg - k1 - d * k2


def fold64(x, w, b, groups, eps, silu):
    """The fold in float64 (autograd's truth for the backward)."""
    n, p, c = x.shape
    xg = x.reshape(n, p, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, p, c) * w + b
    return y * torch.sigmoid(y) if silu else y


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("c,groups,p,loc,scale,eps", [
    (128, 32, 75, 0.0, 1.0, 1e-6),     # 4 channels a group, P not a multiple of the chunk
    (320, 32, 41, 0.0, 1.0, 1e-5),     # 10: a thread's 8 channels straddle two groups
    (640, 32, 29, 100.0, 0.1, 1e-6),   # 20, the cancellation case
    (1280, 32, 13, 0.0, 3.0, 1e-5),    # 40
])
def test_kernel_arithmetic(c, groups, p, loc, scale, eps, silu):
    rng = np.random.default_rng(c + p)
    n, sms = 2, 3  # a few SMs: several chunks a sample, the last one short
    x = torch.from_numpy(rng.normal(loc, scale, (n, p, c)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(1.0, 0.5, c).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(0.0, 0.5, c).astype(np.float32)).bfloat16()
    assert shape_of(x, sms)[2] > 1
    y, mean, rstd = emulate_fwd(x.float(), w.float(), b.float(), groups, eps, silu, sms)
    want = gn.group_norm_plain(x, w, b, groups, eps, silu)
    pre = gn.group_norm_plain(x, w, b, groups, eps)
    scale = (rstd[:, torch.arange(c) // (c // groups)] * w.float())[:, None]
    assert ((y.bfloat16().float() - want.float()).abs() <= fwd_tol(want, pre, x, scale, silu)).all()

    dy = torch.from_numpy(rng.normal(0.0, 1.0, (n, p, c)).astype(np.float32)).bfloat16()
    dx = emulate_bwd(dy.float(), x.float(), w.float(), b.float(), mean, rstd, groups, silu, sms)
    x64 = x.double().requires_grad_()
    (want_dx,) = torch.autograd.grad(fold64(x64, w.double(), b.double(), groups, eps, silu), x64, dy.double())
    err = (dx.double() - want_dx).abs().max() / want_dx.abs().max()
    assert err < (1e-3 if loc else 1e-5)
