"""The CUDA kernels K1-K6 against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. The plain versions
run on the same CUDA tensors. Tolerances: K1 rows atol/rtol 1e-5 (the same
f32 formulas op by op), visibility exact, radius exact; K3 keys, owners and
histogram exact (also at the edges of its slot windows and past its
shared histogram); K4 color/alpha atol 2e-5, depth atol 2e-4, rtol 1e-4
(also on long lists, empty tiles and ragged images), and K4 bitwise
equal on a second launch and under another tile order;
K2 max abs error over max |grad| of each output 1e-4 (hand-derived against
autograd); K5 rows within 1e-4 of the field's max |grad| + 1e-4 relative,
all but 1e-4 of them (a pixel may stop one instance apart, as in K4); K6
within count * 2^-23 * sum |terms| of the float64 sums, and bitwise its
own order of additions (a warp's lane sums added in lane order). K2 and K5 give
bitwise-equal outputs on two launches, and K2 on rows that start past a
16-byte boundary those of aligned copies. K1 from the SH pair
(features_dc, features_rest) is bitwise K1 from one (N, K, 3) tensor, and
with the skip and a screen offset bitwise that table plus the offset,
rows 6-8 zero where no tile; K2 with the SH pair is bitwise K2 with one
tensor. The B-camera chain (K1 into a table's columns, K3, K4 and K5 over
the cameras' bands, K2 accumulating over a strided view of K6's sums) is
bitwise its single views, also past K3's shared histogram. L1 (flash
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


def scene(n, seed, dev, opaque=False, width=W, height=H, left=False):
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    if left:  # the right part of the image stays empty
        means[:, 0] = -np.abs(means[:, 0]) - 0.3
    means[:20, 2] = -4.5  # behind the camera
    scales = np.exp(rng.uniform(-4.0, -1.5, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    op = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    if opaque:
        op = np.clip(op * 4.0, 0.0, 0.999).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    cam = PseudoCamera(R=np.eye(3), T=np.array([0.1, -0.1, 4.0]), FoVx=1.2, FoVy=1.2 * height / width,
                       width=width, height=height).raster_camera(dev)
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


def sh_of(n, k_total, seed, dev):
    """(N, K, 3) SH of K coefficients (band 0 in [-1.5, 1.5])."""
    rng = np.random.default_rng(seed)
    shs = (rng.normal(size=(n, k_total, 3)) * 0.3).astype(np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    return torch.from_numpy(shs).to(dev)


# every (sh_degree, active_degree) pair, K = (sh_degree + 1)^2 or 2 more
# (odd K among them: 1, 3, 9, 11)
@pytest.mark.parametrize("sh_degree,active", [(d, a) for d in range(4) for a in range(d + 1)])
def test_k1_sh_sources_and_skip(dev, sh_degree, active):
    """K1 reads the SH from one (N, K, 3) tensor, from the pair of
    contiguous tensors (features_dc, features_rest) and from the pair as
    slices of one tensor: the same table, bitwise, within the stated
    tolerance of the plain version. With the skip and a screen offset it is
    that table plus the offset, bitwise, with rows 6-8 zero exactly where
    ops/tiling.py::tile_rects counts no tile."""
    k_total = (sh_degree + 1) ** 2 + (2 if active % 2 else 0)
    acts, cam = scene(30000, 30 + 4 * sh_degree + active, dev)
    shs = sh_of(30000, k_total, sh_degree, dev)
    pair = (shs[:, :1].contiguous(), shs[:, 1:].contiguous())
    before = _build.LAUNCHES["preprocess_fwd"]
    full = preprocess_fused.preprocess_fused_fwd(*acts[:4], shs, cam, sh_degree, 0.9, active)
    from_pair = preprocess_fused.preprocess_fused_fwd(*acts[:4], pair, cam, sh_degree, 0.9, active)
    from_slices = preprocess_fused.preprocess_fused_fwd(*acts[:4], (shs[:, :1], shs[:, 1:]), cam, sh_degree,
                                                        0.9, active)
    off = 0.02 * torch.randn((30000, 2), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    skip = preprocess_fused.preprocess_fused_fwd(*acts[:4], pair, cam, sh_degree, 0.9, active,
                                                 means2d_offset=off, skip_unbinned=True)
    assert _build.LAUNCHES["preprocess_fwd"] == before + 4
    assert torch.equal(full, from_pair) and torch.equal(full, from_slices)
    plain = preprocess_fused.preprocess_table_plain(*acts[:4], shs, cam, sh_degree, 0.9, active)
    rows = list(range(10)) + [12, 13]
    torch.testing.assert_close(full[rows], plain[rows], atol=1e-5, rtol=1e-5)
    # the radius, a ceil, may flip where 3 sqrt(lambda1) lands within
    # rounding of an integer: phase 3's allowance of chip_smoke.py
    assert torch.equal(full[11], plain[11]) and int((full[10] != plain[10]).sum()) <= 10
    want = full.clone()
    want[0] = want[0] + off[:, 0] * (0.5 * cam.width)
    want[1] = want[1] + off[:, 1] * (0.5 * cam.height)
    count = tiling.tile_rects(want[0], want[1], preprocess_fused.visible_radii(want), want[12], want[13],
                              cam.width, cam.height)[4]
    want[6:9, count == 0] = 0.0
    assert torch.equal(skip, want)
    assert 0 < int((count > 0).sum()) < 30000 and bool((full[6:9, count == 0] > 0).any())


# every sh_degree instance of K2's template, K = (sh_degree + 1)^2 or more
@pytest.mark.parametrize("sh_degree,k_total", [(3, 16), (2, 11), (1, 4), (0, 1), (0, 4)])
def test_k2_sh_pair_matches_one_tensor(dev, sh_degree, k_total):
    """K2 reading the SH from the pair (features_dc, features_rest), as
    contiguous tensors or as slices of one tensor, and writing its SH
    gradient to the pair: bitwise K2 on the one (N, K, 3) tensor."""
    acts, cam = scene(30001, 40 + sh_degree, dev)
    shs = sh_of(30001, k_total, k_total, dev)
    cot = torch.randn((10, 30001), device=dev)
    one = preprocess_fused.preprocess_fused_bwd(*acts[:4], shs, cam, sh_degree, 0.9, cot)
    for pair in ((shs[:, :1].contiguous(), shs[:, 1:].contiguous()), (shs[:, :1], shs[:, 1:])):
        got = preprocess_fused.preprocess_fused_bwd(*acts[:4], pair, cam, sh_degree, 0.9, cot)
        torch.cuda.synchronize()
        assert got[4][0].shape == (30001, 1, 3) and got[4][1].shape == (30001, k_total - 1, 3)
        for a, b in zip(one[:4] + (one[4],), got[:4] + (torch.cat(got[4], 1),)):
            assert torch.equal(a, b)


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
    c, d, a = (x[0] for x in raster_tiles.blend_fwd_plain(tab, binning, bg, W, H))
    torch.testing.assert_close(out.color, c, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out.alpha, a, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out.depth, d, atol=2e-4, rtol=1e-4)
    assert float(out.color.std()) > 0.01


# K3 takes windows of this many instance slots, and builds its histogram in
# shared memory up to this many tiles (csrc/expand.cu)
K3_WINDOW, K3_HIST_CAP = 512, 12288


def k3_synthetic(dev, seed, gx, gy, n, zero_frac=0.3, max_wh=8, whole=False, land=0.3, long_runs=0.0):
    """K3's arguments for n Gaussians on a gx x gy tile grid with random
    rectangles (count = w h, or 0 for a share zero_frac of them) and
    random conics near them. With probability `land` a Gaussian's count
    ends its instances exactly at a multiple of K3_WINDOW, and a run of
    zero-count Gaussians follows every such boundary; with probability
    `long_runs` a run of 3,000-9,000 zero-count Gaussians follows a
    Gaussian (as Gaussians out of view do in a scene). `whole`: one
    Gaussian's rectangle is the whole grid."""
    rng = np.random.default_rng(seed)
    rects = []
    cum = 0
    while len(rects) < n:
        if rng.random() < long_runs:
            rects += [(int(rng.integers(0, gx)), int(rng.integers(0, gy)), 1, 0)] * int(rng.integers(3000, 9000))
        if cum > 0 and cum % K3_WINDOW == 0:
            rects += [(int(rng.integers(0, gx)), int(rng.integers(0, gy)), 1, 0)] * int(rng.integers(1, 40))
        if whole and len(rects) >= 37 and not any(r[2] * r[3] == gx * gy for r in rects):
            rects.append((0, 0, gx, gy))
        elif rng.random() < land and (fac := [(w, (K3_WINDOW - cum % K3_WINDOW) // w) for w in range(1, gx + 1)
                                              if (K3_WINDOW - cum % K3_WINDOW) % w == 0
                                              and (K3_WINDOW - cum % K3_WINDOW) // w <= gy]):
            w, h = fac[int(rng.integers(len(fac)))]
            rects.append((int(rng.integers(0, gx - w + 1)), int(rng.integers(0, gy - h + 1)), w, h))
        elif rng.random() < zero_frac:
            rects.append((int(rng.integers(0, gx)), int(rng.integers(0, gy)), 1, 0))
        else:
            w, h = int(rng.integers(1, min(max_wh, gx) + 1)), int(rng.integers(1, min(max_wh, gy) + 1))
            rects.append((int(rng.integers(0, gx - w + 1)), int(rng.integers(0, gy - h + 1)), w, h))
        cum += rects[-1][2] * rects[-1][3]
    rmx, rmy, rw, rh = (np.array(c, np.int32) for c in zip(*rects))
    count = rw * rh
    n = len(count)
    tab = np.zeros((16, n), np.float32)
    tab[0] = (rmx + rw * 0.5 + rng.normal(0, 1, n)) * 16
    tab[1] = (rmy + rh * 0.5 + rng.normal(0, 1, n)) * 16
    a, c = np.exp(rng.uniform(-7, -2, n)), np.exp(rng.uniform(-7, -2, n))
    tab[2], tab[4], tab[3] = a, c, rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    tab[5] = rng.uniform(0.0, 1.0, n)
    tab[9] = rng.uniform(0.3, 20.0, n)
    offsets = (np.cumsum(count) - count).astype(np.int32)
    ints = [torch.from_numpy(x).to(dev) for x in (rmx, rmy, rw, count, offsets)]
    return (torch.from_numpy(tab).to(dev), *ints, gx, gx * gy, int(count.sum()))


def check_k3(args):
    before = _build.LAUNCHES["expand"]
    got = expand.expand_instances(*args)
    assert _build.LAUNCHES["expand"] == before + 1
    want = expand.expand_instances_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want[2]


@pytest.mark.parametrize("case", ["whole_image", "zero_runs", "long_zero_runs", "ragged_total", "tiny_total",
                                  "large_grid"])
def test_k3_edge_cases_match_plain(dev, case):
    """K3's slot windows and owner search at their edges, bitwise against
    the plain version: a Gaussian whose rectangle covers the whole image
    (its slots span several windows, so windows start inside it); runs of
    zero-count Gaussians at window and block boundaries, and runs longer
    than a window scans (its owners then found by binary search); a total
    that is not a multiple of the window, or smaller than one; and a grid
    of 65,536 tiles (4096x4096), past the shared histogram."""
    if case == "whole_image":
        args = k3_synthetic(dev, 21, 40, 30, 3000, whole=True)
        assert int(args[4].max()) == 1200 > 2 * K3_WINDOW
    elif case == "zero_runs":
        args = k3_synthetic(dev, 22, 40, 30, 9000, zero_frac=0.9, land=0.5)
        count, offsets = args[4], args[5]
        at_boundary = (count == 0) & (offsets % K3_WINDOW == 0) & (offsets > 0)
        assert int(at_boundary.sum()) > 100
    elif case == "long_zero_runs":
        args = k3_synthetic(dev, 26, 40, 30, 60000, long_runs=0.01, whole=True)
        count = args[4].cpu().numpy()
        runs = np.diff(np.flatnonzero(np.diff(np.r_[1, count, 1] == 0)))[::2]
        assert int(runs.max()) > 4 * K3_WINDOW and int((runs > 4 * K3_WINDOW).sum()) > 3
    elif case == "ragged_total":
        args = k3_synthetic(dev, 23, 40, 30, 5000, land=0.0)
        assert args[-1] % K3_WINDOW != 0 and args[-1] > 20 * K3_WINDOW
    elif case == "tiny_total":
        args = k3_synthetic(dev, 24, 40, 30, 3, zero_frac=0.0, max_wh=3, land=0.0)
        assert args[-1] < K3_WINDOW
    else:
        args = k3_synthetic(dev, 25, 256, 256, 3000, max_wh=20, whole=True)
        assert args[-2] == 65536 > K3_HIST_CAP
    kept = int(check_k3(args).sum())
    assert 0 < kept < args[-1] or case == "tiny_total"  # instances kept and culled


def k4_case(dev, seed, width=W, height=H, **kw):
    acts, cam = scene(60000, seed, dev, width=width, height=height, **kw)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    binning = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), width, height)
    return tab, binning, torch.tensor([0.2, 0.4, 0.6], device=dev)


def check_k4(tab, binning, bg, width, height):
    before = _build.LAUNCHES["blend_fwd"]
    got = raster_tiles._run_fwd(tab, binning, bg, width, height)
    assert _build.LAUNCHES["blend_fwd"] == before + 1
    c, d, a = raster_tiles.blend_fwd_plain(tab, binning, bg, width, height)
    torch.testing.assert_close(got[0], c, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], d, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(got[2], a, atol=2e-5, rtol=1e-4)
    return got


def test_k4_long_lists_and_empty_tiles_match_plain(dev):
    """Tiles whose lists take several 256-instance rounds (each round's
    fields copied while the last is walked) beside empty tiles."""
    tab, binning, bg = k4_case(dev, 31, left=True)
    assert int(binning.tile_count.max()) > 3 * 256
    assert int((binning.tile_count == 0).sum()) > 0
    check_k4(tab, binning, bg, W, H)


@pytest.mark.parametrize("width,height", [(97, 61), (33, 250)])
def test_k4_ragged_image_matches_plain(dev, width, height):
    """Width and height that are not multiples of 16: the edge tiles'
    pixels outside the image count as done and are not written."""
    tab, binning, bg = k4_case(dev, 32, width, height)
    color, depth, alpha = check_k4(tab, binning, bg, width, height)
    assert color.shape == (1, 3, height, width) and depth.shape == alpha.shape == (1, height, width)
    assert float(alpha.max()) > 0.5


def test_k4_is_deterministic_and_order_free(dev):
    """Repeat launches give the same bits, and so does the identity tile
    order in place of the binning's (a tile's pixels depend on its list
    alone)."""
    tab, binning, bg = k4_case(dev, 33, opaque=True)
    first = raster_tiles._run_fwd(tab, binning, bg, W, H)
    second = raster_tiles._run_fwd(tab, binning, bg, W, H)
    num_tiles = binning.grid_x * binning.grid_y
    ident = binning._replace(tile_order=torch.arange(num_tiles, dtype=torch.int32, device=dev))
    assert not torch.equal(ident.tile_order, binning.tile_order)
    third = raster_tiles._run_fwd(tab, ident, bg, W, H)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)


# every sh_degree instance of K2's template, each with k_total = 16
@pytest.mark.parametrize("sh_degree,active", [(3, 3), (3, 1), (1, None), (0, None), (2, None)])
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


def test_k2_is_deterministic(dev):
    """Two launches give bitwise-equal gradients: one thread owns each
    Gaussian's rows, no atomics."""
    acts, cam = scene(30000, 12, dev)
    cot = torch.randn((10, acts[0].shape[0]), device=dev)
    first = preprocess_fused.preprocess_fused_bwd(*acts, cam, 3, 1.0, cot)
    second = preprocess_fused.preprocess_fused_bwd(*acts, cam, 3, 1.0, cot)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k2_unaligned_rows(dev):
    """K2 copies its block's rows into shared memory a float at a time and
    stores them from the first 16-byte boundary on: views that start one
    row in (12 bytes for means and scales) give the gradients of aligned
    copies, bitwise."""
    acts, cam = scene(30001, 13, dev)
    views = [t[1:] for t in acts]
    assert all(t.is_contiguous() for t in views) and views[0].data_ptr() % 16
    cot = torch.randn((10, 30000), device=dev)
    got = preprocess_fused.preprocess_fused_bwd(*views, cam, 3, 1.0, cot)
    want = preprocess_fused.preprocess_fused_bwd(*[t.clone() for t in views], cam, 3, 1.0, cot)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def bwd_case(dev, opaque, n=30000):
    acts, cam = scene(n, 7, dev, opaque)
    bg = torch.tensor([0.2, 0.4, 0.6], device=dev)
    tab = preprocess_fused.preprocess_fused_fwd(*acts, cam, 3, 1.0)
    binning = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), W, H)
    color, depth, alpha = raster_tiles._run_fwd(tab, binning, bg, W, H)
    cot = (torch.randn((1, 3, H, W), device=dev), torch.randn((1, H, W), device=dev),
           torch.randn((1, H, W), device=dev))
    return (tab, binning, color, depth, alpha, *cot, W, H), binning


def check_k5(args, binning):
    got = raster_tiles._run_bwd(*args)
    want = raster_tiles.blend_bwd_plain(*args)
    assert got.shape == (binning.num_instances, 10) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    bad = (err > 1e-4 * want.abs().amax(0, keepdim=True) + 1e-4 * want.abs()).any(1)
    assert float(bad.float().mean()) <= 1e-4
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("opaque", [False, True])
def test_k5_matches_plain(dev, opaque):
    check_k5(*bwd_case(dev, opaque))


def test_k5_crowded_tiles_match_plain(dev):
    """An opaque crowd: tiles of many 256-instance rounds, whose pixels all
    stop inside the first round's 64-instance sub-rounds, so that blocks
    leave long before the end of their lists (the sparser scene of
    test_k5_matches_plain walks into second rounds)."""
    args, binning = bwd_case(dev, True, n=60000)
    assert int(binning.tile_count.max()) > 4 * 256
    stops = []
    for t0, t1 in raster_tiles._tile_batches(binning.tile_count.tolist(), raster_tiles.PLAIN_BATCH_ELEMS):
        q = raster_tiles.tile_batch(args[0], binning, t0, t1)
        stops.append((torch.cumsum(q.trigger.int(), dim=1) == 0).sum(1))  # (tiles, pixels)
    stops = torch.cat(stops)
    stopped = stops < binning.tile_count[:, None].long()
    assert bool((stopped & (stops % 64 != 63)).any())  # inside a sub-round
    assert bool((stops.amax(1) < binning.tile_count.long() - 256).any())  # a block leaves early
    check_k5(args, binning)


@pytest.mark.parametrize("opaque", [False, True])
def test_k5_is_deterministic(dev, opaque):
    """Two launches give bitwise-equal rows: each instance's sums are
    formed by one block in a fixed order, no atomics."""
    args, _ = bwd_case(dev, opaque)
    first = raster_tiles._run_bwd(*args)
    second = raster_tiles._run_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k6_matches_plain(dev):
    args, binning = bwd_case(dev, False)
    grad = raster_tiles._run_bwd(*args)
    got = segsum.segment_sum_sorted(grad, binning.offsets, binning.count)
    want = segsum.segment_sum_sorted_plain(grad, binning.offsets, binning.count)
    bound = binning.count.float() * 2.0 ** -23 * segsum.segment_sum_sorted_plain(
        grad.abs(), binning.offsets, binning.count) + 1e-30
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


# K6 owns this many Gaussians a block (csrc/segsum.cu)
K6_GAUSS = 128


def k6_synthetic(dev, seed, n=6000):
    """K6's arguments: random counts (0-40, a fifth of them 1), Gaussians
    of 300-3,000 slots (many rounds of a warp's 64 rows), zero-count runs
    across block edges and one over four whole blocks, rows of 10 random
    floats; the total is no multiple of 64."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 41, n)
    count[rng.random(n) < 0.5] = 0
    count[rng.random(n) < 0.2] = 1
    count[rng.choice(n, 12, replace=False)] = rng.integers(300, 3000, 12)
    for edge in range(K6_GAUSS, n, 5 * K6_GAUSS):
        count[edge - int(rng.integers(1, 30)):edge + int(rng.integers(1, 30))] = 0
    count[4 * K6_GAUSS:8 * K6_GAUSS] = 0
    count[-1] = 7
    if count.sum() % 64 == 0:
        count[-1] += 1
    offsets = np.cumsum(count) - count
    grad = torch.from_numpy(rng.normal(size=(int(count.sum()), 10)).astype(np.float32)).to(dev)
    return grad, *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (offsets, count))


def k6_in_order(grad, offsets, count):
    """The kernel's order of additions, in float32: for a Gaussian with
    slots, 32 lane sums (lane l: slots l, l + 32, ... in order), then the
    lane sums added in lane order."""
    dev = grad.device
    out = torch.zeros((10, offsets.numel()), device=dev)
    rows_of = lambda s: grad[torch.clamp(s, max=grad.shape[0] - 1).long()]  # noqa: E731
    g = torch.nonzero(count > 0).flatten()
    lo, c = offsets[g].long(), count[g].long()
    lanes = torch.arange(32, device=dev)
    part = torch.zeros((g.numel(), 32, 10), device=dev)
    for j in range(0, int(c.max()), 32):
        s = lo[:, None] + lanes[None, :] + j
        part = torch.where((s < (lo + c)[:, None])[..., None], part + rows_of(s), part)
    total = part[:, 0]
    for lane in range(1, 32):
        total = total + part[:, lane]
    out[:, g] = total.t()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_long_segments_and_zero_runs(dev, seed):
    """K6 on Gaussians of many rounds of a warp's rows, zero-count runs
    across block edges and over whole blocks, and a last block ending
    inside a round: bitwise the kernel's order of additions (so the same
    bits on two launches), and within count 2^-23 sum |g| of the float64
    sums."""
    grad, offsets, count = k6_synthetic(dev, seed)
    before = _build.LAUNCHES["segsum"]
    first = segsum.segment_sum_sorted(grad, offsets, count)
    second = segsum.segment_sum_sorted(grad, offsets, count)
    assert _build.LAUNCHES["segsum"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, k6_in_order(grad, offsets, count))
    want = segsum.segment_sum_sorted_plain(grad, offsets, count)
    bound = count.float() * 2.0 ** -23 * segsum.segment_sum_sorted_plain(grad.abs(), offsets, count) + 1e-30
    assert bool(((first - want).abs() <= bound).all())
    assert not first[:, 4 * K6_GAUSS:8 * K6_GAUSS].any()


def test_k6_unaligned_rows(dev):
    """Rows that start 8 bytes past a 16-byte boundary (a view one row in)
    give the sums of an aligned copy, bitwise; a start off an 8-byte
    boundary is refused."""
    grad, offsets, count = k6_synthetic(dev, 2)
    padded = torch.cat([torch.zeros((1, 10), device=dev), grad])[1:]
    assert padded.is_contiguous() and padded.data_ptr() % 16
    got = segsum.segment_sum_sorted(padded, offsets, count)
    torch.cuda.synchronize()
    assert torch.equal(got, segsum.segment_sum_sorted(grad, offsets, count))
    odd = torch.zeros(grad.numel() + 1, device=dev)[1:].view(-1, 10)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(odd, offsets, count)


L1_SHAPES = [(2, 3, 1200, 64), (1, 1, 300, 512), (3, 2, 77, 32), (1, 2, 200, 128)]
# ragged lengths on both sides of the bf16 kernels' tile edges (64 queries
# a block; 64 keys a tile at D <= 128, 32 at D = 512), and several heads at
# D = 512
RAGGED = (1, 31, 33, 63, 65, 129, 1100)
FWD_SHAPES = L1_SHAPES + [(1, 2, n, 64) for n in RAGGED] + [(1, 1, n, 512) for n in RAGGED] + [(3, 1, 1100, 512)]


def chain_cameras(dev, b, width=W, height=H):
    return [PseudoCamera(R=np.eye(3), T=np.array([0.1 + 0.2 * c, -0.1 + 0.1 * c, 4.0 - 0.3 * c]),
                         FoVx=1.2, FoVy=1.2 * height / width, width=width, height=height).raster_camera(dev)
            for c in range(b)]


def test_chain_matches_single_views(dev):
    """A chain of 3 cameras at a ragged size (136 rows: bands of 9 tile
    rows, 8 of them padding): K1 into its columns of one table (a row
    stride of 3 N) bitwise its single tables; K3 on the chain bitwise its
    plain version; K4's images bitwise the single renders'; K5 + K6's
    per-camera sums bitwise the single renders' (each Gaussian's slots
    hold the same instances in the same order); K2 over a strided view of
    the sums, accumulating, bitwise the sum in camera order of its single
    launches."""
    acts, _ = scene(30000, 21, dev)
    acts[3] = acts[3].reshape(-1)
    cams = chain_cameras(dev, 3)
    n = acts[0].shape[0]
    pair = (acts[4][:, :1], acts[4][:, 1:])
    singles = [preprocess_fused.preprocess_fused_fwd(*acts[:4], pair, c, 3, 1.0, skip_unbinned=True)
               for c in cams]
    chain = torch.empty((16, 3 * n), device=dev)
    for c, cam in enumerate(cams):
        preprocess_fused.preprocess_fused_fwd(*acts[:4], pair, cam, 3, 1.0, skip_unbinned=True, out=chain,
                                              col0=c * n)
    torch.cuda.synchronize()
    assert torch.equal(chain, torch.cat(singles, 1))
    radii = preprocess_fused.visible_radii(chain)
    args = tiling.expand_inputs(chain, radii, W, H, n_cams=3)
    gy_cam = (H + 15) // 16
    got = expand.expand_instances(chain, *args, gy_cam=gy_cam)
    want = expand.expand_instances_plain(chain, *args, gy_cam=gy_cam)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bg = torch.tensor([0.2, 0.4, 0.6], device=dev)
    binning = tiling.bin_gaussians(chain, radii, W, H, n_cams=3)
    color, depth, alpha = raster_tiles._run_fwd(chain, binning, bg, W, H)
    assert color.shape == (3, 3, H, W) and depth.shape == alpha.shape == (3, H, W)
    cot = (torch.randn((3, 3, H, W), device=dev), torch.randn((3, H, W), device=dev),
           torch.randn((3, H, W), device=dev))
    acc = segsum.segment_sum_sorted(raster_tiles._run_bwd(chain, binning, color, depth, alpha, *cot, W, H),
                                    binning.offsets, binning.count)
    grads, want_grads = None, None
    for c, (cam, tab) in enumerate(zip(cams, singles)):
        b1 = tiling.bin_gaussians(tab, preprocess_fused.visible_radii(tab), W, H)
        one = raster_tiles._run_fwd(tab, b1, bg, W, H)
        for x, y in zip(one, (color[c:c + 1], depth[c:c + 1], alpha[c:c + 1])):
            assert torch.equal(x, y)
        acc1 = segsum.segment_sum_sorted(
            raster_tiles._run_bwd(tab, b1, *one, *(x[c:c + 1] for x in cot), W, H), b1.offsets, b1.count)
        assert torch.equal(acc[:, c * n:(c + 1) * n], acc1)
        grads = preprocess_fused.preprocess_fused_bwd(*acts[:4], pair, cam, 3, 1.0, acc[:, c * n:(c + 1) * n],
                                                      accumulate=grads)
        g1 = preprocess_fused.preprocess_fused_bwd(*acts[:4], pair, cam, 3, 1.0, acc1)
        flat = list(g1[:4]) + list(g1[4])
        want_grads = flat if want_grads is None else [w + g for w, g in zip(want_grads, flat)]
    torch.cuda.synchronize()
    for g, w in zip(list(grads[:4]) + list(grads[4]), want_grads):
        assert torch.equal(g, w)


def test_chain_past_the_shared_histogram(dev):
    """11 cameras of 640 x 480 make 11 x 1,200 tiles, past K3's shared
    histogram of 12,288 bins: K3 takes its global histogram, and the
    chain's images are still bitwise the single renders'."""
    acts, _ = scene(20000, 22, dev)
    pair = (acts[4][:, :1], acts[4][:, 1:])
    width, height = 640, 480
    cams = chain_cameras(dev, 11, width, height)
    bg = torch.tensor([0.2, 0.4, 0.6], device=dev)
    multi = raster_tiles.rasterize_tiles_multi(*acts[:4], pair, cams, bg)
    assert 11 * 40 * 30 > 12288
    for c, cam in enumerate(cams):
        one = raster_tiles.rasterize_tiles(*acts[:4], pair, cam, bg)
        assert torch.equal(multi.color[c], one.color) and torch.equal(multi.alpha[c], one.alpha)
        assert torch.equal(multi.depth[c], one.depth) and torch.equal(multi.radii[c], one.radii)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", FWD_SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1200, 64), (3, 1, 1100, 512), (3, 2, 77, 32), (1, 2, 200, 128)])
def test_l1_fwd_is_deterministic(dev, dtype, shape):
    """Two launches of the forward give a bitwise-equal output and
    log-sum-exp: one owner per row, keys in a fixed order, no atomics."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    scale = shape[3] ** -0.5
    first = flash_attention.flash_attention_lse(q, k, v, scale)
    second = flash_attention.flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_l1_fwd_rejects_misaligned_bf16(dev):
    """The bf16 kernels copy 16-byte pieces (TMA): a view one element past
    an aligned start raises before any launch."""
    shape = (1, 2, 64, 64)
    base = torch.randn(1 + 2 * 64 * 64, device=dev).to(torch.bfloat16)
    q = base[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16
    ok = torch.randn(shape, device=dev).to(torch.bfloat16)
    before = _build.LAUNCHES["flash_attn_fwd"]
    for args in ((q, ok, ok), (ok, q, ok), (ok, ok, q)):
        with pytest.raises(ValueError):
            flash_attention.flash_attention(*args, 0.125)
        with pytest.raises(ValueError):
            flash_attention.flash_attention_lse(*args, 0.125)
    assert _build.LAUNCHES["flash_attn_fwd"] == before


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


# ragged lengths on both sides of the bf16 backward kernels' tile edges (64
# rows at D <= 128, 32 at D = 512), and several heads at D = 512
BWD_SHAPES = L1_SHAPES + [(1, 2, n, 64) for n in RAGGED] + [(1, 1, n, 512) for n in RAGGED[:-1]] + [(3, 1, 1100, 512)]


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
    # at n = 1 the softmax is 1, so dq and dk are 0 up to rounding: there
    # every output is measured against the largest of the three
    top = max(float(w.float().abs().max()) for w in want) if shape[2] == 1 else 0.0
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape and bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), top) <= tol

    grads = []
    for fn in (flash_attention.flash_attention, flash_attention.flash_attention_plain_autograd):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, scale), leaves, do))
    for g, w in zip(*grads):
        assert float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), top) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 1200, 64), (3, 1, 1100, 512), (3, 2, 77, 32), (1, 2, 200, 128)])
def test_l1_bwd_is_deterministic(dev, dtype, shape):
    """Two launches of the dK/dV and dQ kernels give bitwise-equal dq, dk,
    dv: one owner sums each element in a fixed order, no atomics."""
    q, k, v, do = l1_inputs(dev, shape, dtype, 11)
    scale = shape[3] ** -0.5
    out, lse = flash_attention.flash_attention_lse(q, k, v, scale)
    first = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
    second = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
