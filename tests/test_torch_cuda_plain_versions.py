"""`ops/_build.py::plain_versions` on the card: a toy bf16 UNet
application launches kernels L1, L2 and N1, forward and backward, outside
the scope and none of them inside it.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. Run on the card
without the reference package's conftest (it imports JAX):

    python -m pytest tests/test_torch_cuda_plain_versions.py -m cuda --noconftest -p no:cacheprovider
"""

import pytest
import torch

from guidedvd3dgs_tpu_torch.diffusion import init, unet3d
from guidedvd3dgs_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda

# forward and backward entries of L1, L2 and N1
KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "short_attn_fwd", "short_attn_bwd", "group_norm_fwd",
           "group_norm_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def test_toy_unet_launches_no_kernel_inside_the_scope(dev):
    """One level at 32x32 latents: its spatial self-attention holds 1024
    tokens (L1), its cross-attention 77 and 16 keys and its temporal
    attention 2 frames at 64-dim heads (L2), its GroupNorms 64 channels
    (N1). dL/dx runs each kernel's backward."""
    cfg = unet3d.UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
                            num_head_channels=64, context_dim=64, temporal_length=2)
    p = init.init_unet_params(cfg, init._Init(0, dev, torch.bfloat16))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, 2, 32, 32, 8), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((1, 77 + 2 * 16, 64), generator=g, device=dev).to(torch.bfloat16)
    ts = torch.tensor([500], device=dev)

    def launches():
        before = dict(_build.LAUNCHES)
        xl = x.clone().requires_grad_()
        out = unet3d.unet_apply(p, cfg, xl, ts, ctx)
        (gx,) = torch.autograd.grad(out.float().square().sum(), xl)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(gx).all())
        return {name: _build.LAUNCHES[name] - before[name] for name in KERNELS}

    outside = launches()
    assert all(outside.values()), outside
    with _build.plain_versions():
        inside = launches()
    assert not any(inside.values()), inside
    assert all(launches().values())
