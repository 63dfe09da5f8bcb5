"""The CUDA kernels K1, K3, K4 against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere. The plain versions
run on the same CUDA tensors. Tolerances: K1 rows atol/rtol 1e-5 (the same
f32 formulas op by op), visibility exact, radius exact; K3 keys, owners and
histogram exact; K4 color/alpha atol 2e-5, depth atol 2e-4, rtol 1e-4.
Run on the card without the reference package's conftest (it imports
JAX):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu_torch.ops import _build, expand, preprocess_fused, raster_tiles, tiling
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
