"""Kernel N1's tolerances against its plain version, shared by its tests,
`chip_smoke.py` and `scripts/group_norm_ab.py` (no JAX, no pytest).

`fwd_tol`, the forward's tolerance against the plain bf16 fold: one bf16
ulp of the output; plus, where the fold cancels (x * scale and shift
nearly opposite, |mean| / std large), 2^-20 |x * scale| (a few f32 ulps of
the product, and the statistics' own rounding); plus, with SiLU, 0.6 bf16
ulp of the normalised value, since the plain version rounds it to bf16
before its SiLU (twice rounded, three bf16 ulps apart in SiLU's negative
tail) where the kernel rounds once.

`bwd_tol`, the backward's tolerance against autograd through the plain
version on the float32 copy of the same input: 2^-8 |dx| + 1e-3 max |dx|
(dx is rounded to bf16 once; the kernel's f32 group sums carry a relative
1e-5, 4e-4 where |mean| / std is 1000).
"""

import torch


def ulp_bf16(v):
    return 2.0 ** (torch.floor(torch.log2(v.float().abs().clamp_min(2 ** -100))) - 7)


def fwd_tol(plain_out, plain_pre, x, scale, silu):
    """plain_out: the plain version's output; plain_pre its output without
    SiLU; x (N, P, C) and scale (N, 1, C) = rstd * w."""
    cancel = 2.0 ** -20 * (x.float() * scale).abs()
    if silu:
        return ulp_bf16(plain_out) + 0.6 * ulp_bf16(plain_pre) + 1.1 * cancel
    return ulp_bf16(plain_out) + cancel


def bwd_tol(want):
    """want: dx through the plain version in float32."""
    return 2.0 ** -8 * want.abs() + 1e-3 * want.abs().max()
