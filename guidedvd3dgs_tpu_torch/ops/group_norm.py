"""Kernel N1: channels-last GroupNorm, with the SiLU after it where asked,
forward and backward, and its plain version.

Counterpart of `guidedvd3dgs_tpu/diffusion/nnops.py::group_norm` (left to
XLA there: no Pallas kernel) followed by `silu`. The plain version is the
port's own eager form: f32 inputs take the two-pass form, half-precision
inputs the reference's fold x * scale + shift in f32, cast back. The CUDA
kernels (csrc/group_norm.cu) compute that fold in two launches forward
(the statistics, then the output with SiLU fused) and two backward (the
group sums, then dx), for bf16 activations, behind the autograd Function
`_GroupNorm`. `diffusion/nnops.py::group_norm` sends here what
`takes_kernel` accepts: CUDA bf16 activations whose weight and bias need
no gradient (the port never asks for one: the guided sampler
differentiates the latent only), outside `_build.plain_versions()`.
Everything else takes the plain version.
What is sent here the kernels take, or `prepare` raises: x is copied
where it is not contiguous at a 16-byte boundary, the weight and bias are
taken in x's dtype (as every layer of nnops takes its weight), and C must
be a multiple of 8 and of the groups with a block shape (`threads_for`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.utils.tracing import count

VEC = 8  # channels a thread loads at once (16 bytes)
MIN_THREADS = 256
MAX_THREADS = 512  # csrc/group_norm.cu GN_MAX_THREADS
BLOCKS_PER_SM = 2  # the grid's target, all blocks resident at once (scripts/group_norm_ab.py sweeps it)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                     eps: float, silu: bool = False) -> torch.Tensor:
    """Channels-last GroupNorm with f32 statistics (reference nnops.py:77-110),
    then SiLU if `silu`. f32 inputs take the two-pass form; half-precision
    inputs take the reference's folded form x*scale + shift in f32, cast
    back, with the statistics from one var_mean pass over the f32 copy and
    the fold as one addcmul (the activation is read and written as few
    times as the f32 form allows)."""
    c = x.shape[-1]
    g = num_groups
    xg = x.reshape(x.shape[:-1] + (g, c // g))
    red = tuple(range(1, x.dim() - 1)) + (x.dim(),)
    w = weight.float()
    b = bias.float()
    if x.dtype == torch.float32:
        mean = xg.mean(dim=red, keepdim=True)
        var = xg.var(dim=red, keepdim=True, correction=0)
        xg = (xg - mean) * torch.rsqrt(var + eps)
        y = xg.reshape(x.shape) * w + b
    else:
        xf = xg.float()
        var, mean = torch.var_mean(xf, dim=red, keepdim=True, correction=0)
        scale = torch.rsqrt(var + eps) * w.reshape(g, c // g)
        shift = b.reshape(g, c // g) - mean * scale
        y = torch.addcmul(shift, xf, scale).reshape(x.shape).to(x.dtype)
    return F.silu(y) if silu else y


def takes_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernels take this call (module docstring): decided from
    what the tensors show and `_build.plain_versions()`, nothing else."""
    return (not _build.forced_plain() and x.is_cuda and x.dtype == torch.bfloat16
            and not weight.requires_grad and not bias.requires_grad)


def threads_for(c: int):
    """A block's threads for C channels: R whole rows of C/8 threads, at
    least MIN_THREADS, a multiple of 32; None past MAX_THREADS."""
    vpr = c // VEC
    if vpr <= 0:
        return None
    r = -(-MIN_THREADS // vpr)
    while (r * vpr) % 32:
        r += 1
    return r * vpr if r * vpr <= MAX_THREADS else None


def geometry(n: int, p: int, c: int, sms: int, blocks_per_sm: int):
    """(threads, chunk, S): block (s, i) of the grid (S, n) owns rows
    [s*chunk, min((s+1)*chunk, p)) of sample i. About `blocks_per_sm`
    blocks an SM over the whole grid, a chunk whole steps of the block's R
    rows (at least one step), no chunk empty."""
    threads = threads_for(c)
    if threads is None:
        raise ValueError(f"no GroupNorm kernel shape for {c} channels")
    r = threads // (c // VEC)
    s = max(1, min(-(-blocks_per_sm * sms // n), -(-p // r)))
    per = -(-p // s)
    chunk = -(-per // r) * r
    return threads, chunk, -(-p // chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _plan(shape: torch.Size, index: int, blocks_per_sm: int):
    """(n, p, c, threads, chunk, S) of an input of `shape` on card `index`."""
    n, c = shape[0], shape[-1]
    p = math.prod(shape[1:-1])
    return (n, p, c) + geometry(n, p, c, _sms(index), blocks_per_sm)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte boundary, as the kernels' 16-byte loads
    read it: t itself where it is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def prepare(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int):
    """(x, weight, bias) as the kernels read them (module docstring), or
    ValueError where they cannot take the call."""
    x = aligned(x)
    c = x.shape[-1] if x.dim() >= 3 else 0
    if not (x.is_cuda and x.dtype == torch.bfloat16) or c % VEC or c % num_groups or threads_for(c) is None:
        raise ValueError(f"no GroupNorm kernel for x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"{num_groups} groups")
    weight, bias = weight.to(x.dtype).contiguous(), bias.to(x.dtype).contiguous()
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: expected ({c},) on {x.device}")
    return x, weight, bias


def _forward(x, weight, bias, num_groups: int, eps: float, silu: bool, blocks_per_sm: int = BLOCKS_PER_SM):
    """The forward launch on what `prepare` returned: (y, stats), stats
    (2, N, G) f32 holding mean and rstd."""
    n, p, c, threads, chunk, s = _plan(x.shape, x.get_device(), blocks_per_sm)
    stats = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    ws = torch.empty((n, s, num_groups, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    sp = stats.data_ptr()
    _build.launch("group_norm_fwd", x.data_ptr(), weight.data_ptr(), bias.data_ptr(), n, p, c, num_groups, chunk,
                  s, threads, eps, int(silu), ws.data_ptr(), sp, sp + 4 * n * num_groups, y.data_ptr(),
                  _build.stream_of(x))
    return y, stats


def _backward(dy, x, weight, bias, stats, num_groups: int, silu: bool, blocks_per_sm: int = BLOCKS_PER_SM):
    """The backward launch: dx from dy (like x) and the forward's x, weight,
    bias and stats."""
    n, p, c, threads, chunk, s = _plan(x.shape, x.get_device(), blocks_per_sm)
    dy = aligned(dy)
    ws = torch.empty((n, s, num_groups, 2), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    sp = stats.data_ptr()
    _build.launch("group_norm_bwd", x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), n, p, c,
                  num_groups, chunk, s, threads, int(silu), sp, sp + 4 * n * num_groups, ws.data_ptr(),
                  dx.data_ptr(), _build.stream_of(x))
    return dx


class _GroupNorm(torch.autograd.Function):
    """The kernels under autograd: the gradient of x only (weight and bias
    need none, `takes_kernel`). Saves x and the (2, N, G) statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        y, stats = _forward(x, weight, bias, num_groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        count("nn.group_norm.kernel_bwd")
        return _backward(dy, x, weight, bias, stats, ctx.num_groups, ctx.silu), None, None, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
               silu: bool = False) -> torch.Tensor:
    """Kernel N1 on what `takes_kernel` accepts (x (N, ..., C), groups over
    all but the first axis), under autograd where x needs its gradient;
    counted under "nn.group_norm.kernel"."""
    count("nn.group_norm.kernel")
    x, weight, bias = prepare(x, weight, bias, num_groups)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, silu)
    return _forward(x, weight, bias, num_groups, eps, silu)[0]
