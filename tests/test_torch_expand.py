"""Kernel K3's plain version plus the key sort against the reference binning.

The reference binning (`tiling.bin_gaussians`, its expansion kernel in
interpret mode, exact f32 mode) and the port's `tiling.bin_gaussians` (CPU
path: plain K3 + one stable 64-bit sort) take the SAME preprocessed
Gaussians, the reference's. The per-tile histogram must be equal, and
within each tile the owner ids equal in depth order. The reference sorts
by depth quantized to `depth_bits`, so depths here are spread further
apart than its quantum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.ops.projection import preprocess_gaussians as jax_preprocess
from guidedvd3dgs_tpu_torch.ops import expand, tiling

from helpers import make_camera

torch.set_num_threads(2)

W, H = 72, 56


@pytest.fixture(autouse=True)
def _interpret_exact():
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    yield
    jax_raster_tiles.set_interpret(prev)
    jax_tiling.set_pack_fields(True)


def depth_separated_scene(n, seed):
    """Gaussians in front of make_camera's camera (at z = -4 looking +z)
    with distinct depths 2 * 4 / n apart."""
    rng = np.random.default_rng(seed)
    xyz = np.empty((n, 3), np.float32)
    xyz[:, 2] = rng.permutation(np.linspace(-2.0, 2.0, n)).astype(np.float32)
    depth = xyz[:, 2] + 4.0
    xyz[:, 0] = rng.uniform(-0.6, 0.6, n) * depth
    xyz[:, 1] = rng.uniform(-0.5, 0.5, n) * depth
    scales = np.exp(rng.uniform(-4.0, -2.0, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    opac[:5] = 1e-3  # never visible: empty rect
    sh = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return xyz, scales, rots, opac, sh


def table_from_reference(proc):
    """The port's (16, N) table layout filled from reference preprocess
    outputs, so both binnings bin identical values."""
    n = proc.means2d.shape[0]
    tab = np.zeros((16, n), np.float32)
    tab[0:2] = np.asarray(proc.means2d).T
    tab[2:5] = np.asarray(proc.conics).T
    tab[5] = np.asarray(proc.opacities)
    tab[6:9] = np.asarray(proc.colors).T
    tab[9] = np.asarray(proc.depths)
    tab[11] = np.asarray(proc.visible)
    tab[12] = np.asarray(proc.ext_x)
    tab[13] = np.asarray(proc.ext_y)
    return torch.from_numpy(tab), torch.from_numpy(np.array(proc.radii))


@pytest.mark.parametrize("n,seed", [(500, 0), (1500, 1)])
def test_binning_matches_reference(n, seed):
    cam = make_camera(height=H, width=W).raster_camera()
    proc = jax_preprocess(*map(jnp.asarray, depth_separated_scene(n, seed)), cam)
    ref = jax_tiling.bin_gaussians(proc, W, H, max_instances=32768)
    assert int(ref.overflow) == 0
    tab, radii = table_from_reference(proc)
    port = tiling.bin_gaussians(tab, radii, W, H)

    assert (port.grid_x, port.grid_y) == (ref.grid_x, ref.grid_y)
    ref_count = np.asarray(ref.tile_count)
    np.testing.assert_array_equal(port.tile_count.numpy(), ref_count)
    assert ref_count.sum() > n // 2  # the scene covers the image
    _, _, _, _, count, _, _ = jax_tiling.tile_rects(proc, W, H)
    assert port.num_instances == int(np.asarray(count).sum())
    # culled instances exist and sort past the last tile
    assert port.num_instances > ref_count.sum()

    ref_start, ref_ids = np.asarray(ref.tile_start), np.asarray(ref.inst_gauss)
    port_start, port_ids = port.tile_start.numpy(), port.inst_gauss.numpy()
    for t in range(port.grid_x * port.grid_y):
        c = ref_count[t]
        np.testing.assert_array_equal(
            port_ids[port_start[t] : port_start[t] + c],
            ref_ids[ref_start[t] : ref_start[t] + c],
            err_msg=f"tile {t}",
        )


def test_tile_rects_match_reference():
    cam = make_camera(height=H, width=W).raster_camera()
    proc = jax_preprocess(*map(jnp.asarray, depth_separated_scene(800, 2)), cam)
    ref = jax_tiling.tile_rects(proc, W, H)
    tab, radii = table_from_reference(proc)
    port = tiling.tile_rects(tab[0], tab[1], radii, tab[12], tab[13], W, H)
    for name, p, r in zip(("min_x", "min_y", "w", "h", "count"), port[:5], ref[:5]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
    assert port[5:] == tuple(ref[5:])


def test_expand_plain_keys_and_owners():
    """Keys carry tile << 32 | depth bits; instances follow each Gaussian's
    offset in row-major rectangle order."""
    n = 3
    tab = torch.zeros((16, n))
    tab[0] = torch.tensor([8.0, 40.0, 24.0])  # means at tile centers
    tab[1] = torch.tensor([8.0, 8.0, 24.0])
    tab[2] = tab[4] = 0.01  # round conic, broad enough to reach every tile
    tab[5] = 0.9
    tab[9] = torch.tensor([3.0, 1.0, 2.0])
    rmx = torch.tensor([0, 2, 0], dtype=torch.int32)
    rmy = torch.tensor([0, 0, 1], dtype=torch.int32)
    rw = torch.tensor([2, 1, 3], dtype=torch.int32)
    count = torch.tensor([2, 0, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 2], dtype=torch.int32)
    keys, owners, hist = expand.expand_instances(tab, rmx, rmy, rw, count, offsets, 3, 6, 5)
    tiles = (keys >> 32).tolist()
    assert owners.tolist() == [0, 0, 2, 2, 2]
    assert tiles == [0, 1, 3, 4, 5]
    depth_bits = (keys & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    assert depth_bits.tolist() == [3.0, 3.0, 2.0, 2.0, 2.0]
    assert hist.tolist() == [1, 1, 0, 1, 1, 1]
