"""The CUDA kernels K1-K6 against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. The plain versions
run on the same CUDA tensors. Tolerances: K1 rows atol/rtol 1e-5 (the same
f32 formulas op by op), visibility exact, radius exact; K3 keys, owners and
histogram exact; K4 color/alpha atol 2e-5, depth atol 2e-4, rtol 1e-4;
K2 max abs error over max |grad| of each output 1e-4 (hand-derived against
autograd); K5 rows within 1e-4 of the field's max |grad| + 1e-4 relative,
all but 1e-4 of them (a pixel may stop one instance apart, as in K4); K6
within count * 2^-23 * sum |terms| of the float64 sums; L1 (flash
attention) within 2e-5 of its plain version in float32 and 1e-2 in
bfloat16 (the plain version from the same bf16 inputs) on unit-normal
inputs (other sum orders; the plain version rounds the weights to bf16);
L1's log-sum-exp within 1e-4 of torch.logsumexp of the float32 logits;
L1's backward (dq, dk, dv) within 1e-4 of max |grad| of its plain
backward in float32 and 2e-2 in bfloat16 (the tensor-core kernels round
dS to bf16 for its two products; the plain version keeps it float32).
Run on the card without the reference package's conftest (it imports
JAX):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu_torch.ops import _build, expand, flash_attention, preprocess_fused, raster_tiles, segsum, tiling
from guidedvd3dgs_tpu_torch.scene.cameras import PseudoCamera

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

W, H = 200, 136  # not multiples of 16: ragged edge tiles


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def scene(n, seed, dev, opaque=False):
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    means[:20, 2] = -4.5  # behind the camera
    scales = np.exp(rng.uniform(-4.0, -1.5, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    op = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    if opaque:
        op = np.clip(op * 4.0, 0.0, 0.999).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    cam = PseudoCamera(R=np.eye(3), T=np.array([0.1, -0.1, 4.0]), FoVx=1.2, FoVy=1.2 * H / W,
                       width=W, height=H).raster_camera(dev)
    return [torch.from_numpy(a).to(dev) for a in (means, scales, rots, op, shs)], cam


@pytest.mark.parametrize("sh_degree,active", [(0, None), (1, 0), (3, None), (3, 2)])
def test_k1_matches_plain(dev, sh_degree, active):
    acts, cam = scene(30000, sh_degree, dev)
    before = _build.LAUNCHES["preprocess_fwd"]
    k = preprocess_fused.preprocess_fused_fwd(*acts, cam, sh_degree, 0.9, active_degree=active)
    assert _build.LAUNCHES["preprocess_fwd"] == before + 1
    p = preprocess_fused.preprocess_table_plain(*acts, cam, sh_degree, 0.9, active_degree=active)
    rows = list(range(10)) + [12, 13]
    torch.testing.assert_close(k[rows], p[rows], atol=1e-5, rtol=1e-5)
    assert torch.equal(k[10:12], p[10:12])
    assert 0 < int(k[11].sum()) < k.shape[1]


def test_k1_rejects_what_it_does_not_take(dev):
    acts, cam = scene(100, 0, dev)
    with pytest.raises(ValueError):
        preprocess_fused.preprocess_fused_fwd(acts[0].double(), *acts[1:], cam, 3, 1.0)
    with pytest.raises(ValueError):
        preprocess_fused.preprocess_fused_fwd(acts[0].t().contiguous().t(), *acts[1:], cam, 3, 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_matches_plain(dev, seed):
    acts, cam = scene(30000, seed, dev)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    args = (tab, *tiling.expand_inputs(tab, preprocess_fused.visible_radii(tab), W, H))
    for a, b in zip(expand.expand_instances(*args), expand.expand_instances_plain(*args)):
        assert torch.equal(a, b)
    assert args[-1] > 30000


@pytest.mark.parametrize("opaque", [False, True])
def test_k4_matches_plain(dev, opaque):
    acts, cam = scene(30000, 5, dev, opaque)
    bg = torch.tensor([0.2, 0.4, 0.6], device=dev)
    out = raster_tiles.rasterize_tiles(*acts, cam, bg)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    binning = tiling.bin_gaussians(tab, out.radii, W, H)
    c, d, a = raster_tiles.blend_fwd_plain(tab, binning, bg, W, H)
    torch.testing.assert_close(out.color, c, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out.alpha, a, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out.depth, d, atol=2e-4, rtol=1e-4)
    assert float(out.color.std()) > 0.01


@pytest.mark.parametrize("sh_degree,active", [(3, 3), (3, 1), (1, None)])
def test_k2_matches_plain(dev, sh_degree, active):
    acts, cam = scene(30000, 10 + sh_degree, dev)
    acts[3] = acts[3].reshape(-1)
    cot = torch.randn((10, acts[0].shape[0]), device=dev)
    before = _build.LAUNCHES["preprocess_bwd"]
    got = preprocess_fused.preprocess_fused_bwd(*acts, cam, sh_degree, 0.9, cot, active_degree=active)
    assert _build.LAUNCHES["preprocess_bwd"] == before + 1
    want = preprocess_fused.preprocess_fused_bwd_plain(*acts, cam, sh_degree, 0.9, cot,
                                                       active_degree=active)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)) <= 1e-4


def bwd_case(dev, opaque):
    acts, cam = scene(30000, 7, dev, opaque)
    bg = torch.tensor([0.2, 0.4, 0.6], device=dev)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    binning = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), W, H)
    color, depth, alpha = raster_tiles._run_fwd(tab, binning, bg, W, H)
    cot = (torch.randn((3, H, W), device=dev), torch.randn((H, W), device=dev),
           torch.randn((H, W), device=dev))
    return (tab, binning, color, depth, alpha, *cot, W, H), binning


@pytest.mark.parametrize("opaque", [False, True])
def test_k5_matches_plain(dev, opaque):
    args, binning = bwd_case(dev, opaque)
    got = raster_tiles._run_bwd(*args)
    want = raster_tiles.blend_bwd_plain(*args)
    assert got.shape == (binning.num_instances, 10) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    bad = (err > 1e-4 * want.abs().amax(0, keepdim=True) + 1e-4 * want.abs()).any(1)
    assert float(bad.float().mean()) <= 1e-4
    assert float(want.abs().max()) > 0


def test_k6_matches_plain(dev):
    args, binning = bwd_case(dev, False)
    grad = raster_tiles._run_bwd(*args)
    got = segsum.segment_sum_sorted(grad, binning.offsets, binning.count)
    want = segsum.segment_sum_sorted_plain(grad, binning.offsets, binning.count)
    bound = binning.count.float() * 2.0 ** -23 * segsum.segment_sum_sorted_plain(
        grad.abs(), binning.offsets, binning.count) + 1e-30
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 3, 1200, 64), (1, 1, 300, 512), (3, 2, 77, 32), (1, 2, 200, 128)])
def test_l1_matches_plain(dev, dtype, tol, shape):
    gen = torch.Generator(device=dev)
    gen.manual_seed(shape[2])
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    scale = shape[3] ** -0.5
    before = _build.LAUNCHES["flash_attn_fwd"]
    got = flash_attention.flash_attention(q, k, v, scale)
    assert _build.LAUNCHES["flash_attn_fwd"] == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_l1_rejects_what_it_does_not_take(dev):
    q = torch.randn((1, 2, 64, 64), device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                                        q[..., :48].contiguous(), 0.125)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), 0.125)
    # an input that requires grad takes the autograd Function: its backward
    # launches the dK/dV and dQ kernels once each
    leaves = [q.clone().requires_grad_() for _ in range(3)]
    out = flash_attention.flash_attention(*leaves, 0.125)
    before = dict(_build.LAUNCHES)
    out.square().sum().backward()
    for name in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        assert _build.LAUNCHES[name] == before[name] + 1
    for t in leaves:
        assert t.grad.shape == q.shape and bool(torch.isfinite(t.grad).all())


BWD_SHAPES = [(2, 3, 1200, 64), (1, 1, 300, 512), (3, 2, 77, 32), (1, 2, 200, 128)]


def l1_inputs(dev, shape, dtype, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_l1_lse_matches_logsumexp(dev, dtype, shape):
    q, k, v, _ = l1_inputs(dev, shape, dtype, 7)
    scale = shape[3] ** -0.5
    out, lse = flash_attention.flash_attention_lse(q, k, v, scale)
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == shape[:3]
    assert float((lse - want).abs().max()) <= 1e-4
    assert torch.equal(out, flash_attention.flash_attention(q, k, v, scale))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_l1_bwd_matches_plain(dev, dtype, tol, shape):
    """dq, dk, dv of the two kernels against the plain backward of the same
    inputs, max abs error over max |grad|; and the Function under autograd
    against the plain pair (nnops.attention(plain=True)'s)."""
    q, k, v, do = l1_inputs(dev, shape, dtype, shape[2] + 1)
    scale = shape[3] ** -0.5
    out, lse = flash_attention.flash_attention_lse(q, k, v, scale)
    before = dict(_build.LAUNCHES)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
    for name in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        assert _build.LAUNCHES[name] == before[name] + 1
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape and bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= tol

    grads = []
    for fn in (flash_attention.flash_attention, flash_attention.flash_attention_plain_autograd):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, scale), leaves, do))
    for g, w in zip(*grads):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= tol
