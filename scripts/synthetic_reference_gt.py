"""The synthetic scene as the reference's tool writes it: ground-truth images
without the instances the reference renderer drops.

    python scripts/synthetic_reference_gt.py --out <scene_dir> [--device cuda]

tools/make_synthetic_scene.py renders its ground-truth images with the
reference tile rasterizer at its default instance capacity: max(4 N, 16384)
slots rounded up to a multiple of `tiling.QUANTUM` (512)
(`guidedvd3dgs_tpu/ops/raster_tiles.py`, rasterize_tiles). Every Gaussian
takes max(count, 1) slots in index order, and the instances in slots past
the capacity are dropped (`TileBinning.overflow`). The port sizes its
buffers exactly, so `synthetic.make_scene` writes the exact images.

This script writes the tool-default scene with `make_scene` (the same
positions, cameras, init cloud and split), then rewrites every camera's
image as the reference renders it: without the Gaussians whose slots lie
past the capacity. A Gaussian that straddles the capacity is dropped
whole, where the reference keeps its first slots. Per camera it prints
the instances the view needs, the reference's slots, the instances the
reference drops, the Gaussians removed here, and the PSNR of the dropped
image against the exact one.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from guidedvd3dgs_tpu_torch.convert import params_from_numpy  # noqa: E402
from guidedvd3dgs_tpu_torch.models.render import eval_render  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import preprocess_fused, tiling  # noqa: E402
from guidedvd3dgs_tpu_torch.render import resolve_device  # noqa: E402
from guidedvd3dgs_tpu_torch.scene import synthetic  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.image_io import save_image  # noqa: E402
from guidedvd3dgs_tpu_torch.utils.losses import psnr  # noqa: E402

# the tool's defaults
WIDTH, HEIGHT, FOV_DEG, N_CAMS = 624, 352, 70.0, 60
# guidedvd3dgs_tpu.ops.tiling.QUANTUM at the reference's default block sizes
REFERENCE_QUANTUM = 512


def reference_capacity(n: int) -> int:
    """The reference rasterizer's default instance capacity for n Gaussians."""
    return -(-max(4 * n, 1 << 14) // REFERENCE_QUANTUM) * REFERENCE_QUANTUM


def tile_rects(params, cam, width: int, height: int):
    """Each Gaussian's tile rectangle in this view: (rect_min_x, rect_min_y,
    width in tiles, tiles covered (0 if culled), each (N,); the grid's
    width in tiles). The reference walks a rectangle row by row, so its
    slot i is tile (rect_min_x + i % w, rect_min_y + i // w)."""
    with torch.no_grad():
        acts = (params.xyz, params.get_scaling, params.get_rotation, params.get_opacity,
                params.get_features)
        tab = preprocess_fused.preprocess_table_plain(*acts, cam, 3, 1.0)
        rmx, rmy, w, count, _, gx, _, _ = tiling.expand_inputs(tab, preprocess_fused.visible_radii(tab),
                                                               width, height)
        return rmx, rmy, w, count, gx


def tile_counts(params, cam, width: int, height: int) -> torch.Tensor:
    """(N,) tiles each Gaussian covers in this view (0 if culled)."""
    return tile_rects(params, cam, width, height)[3]


def reference_drop(count: torch.Tensor, capacity: int):
    """The reference's slot arithmetic: (Gaussians kept here (N,) bool,
    instances the reference drops, slots it takes)."""
    count = count.long()
    end = torch.cumsum(torch.clamp(count, min=1), 0)  # inclusive end slot of each Gaussian
    dropped = int(torch.minimum(torch.clamp(end - capacity, min=0), count).sum())
    kept = (end <= capacity) | (count == 0)
    return kept, dropped, int(end[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    info = synthetic.make_scene(a.out, HEIGHT, WIDTH, n_cams=N_CAMS, fov_deg=FOV_DEG, device=dev)
    gt, train_ids = info["gt"], info["train_ids"]
    _, cams = synthetic.orbit(N_CAMS, WIDTH, HEIGHT, FOV_DEG, np.random.default_rng(0))
    params = params_from_numpy(gt, dev)
    capacity = reference_capacity(gt["xyz"].shape[0])
    bg = torch.zeros(3, device=dev)
    for i, c in enumerate(cams):
        cam = c.raster_camera(dev)
        count = tile_counts(params, cam, WIDTH, HEIGHT)
        kept, dropped, slots = reference_drop(count, capacity)
        line = (f"camera {i:2d} ({'train' if i in train_ids else 'test'}): instances "
                f"{int(count.sum())}, reference slots {slots}, capacity {capacity}, dropped "
                f"{dropped}, Gaussians removed {int((~kept).sum())}")
        if dropped:
            with torch.no_grad():
                exact = eval_render(params, cam, bg, 3).color.clamp(0, 1)
                keep = kept.cpu().numpy()
                cut = eval_render(params_from_numpy({k: v[keep] for k, v in gt.items()}, dev),
                                  cam, bg, 3).color.clamp(0, 1)
            save_image(cut.cpu().numpy(), os.path.join(a.out, "images", f"frame_{i:05d}.png"))
            line += f", PSNR of the reference's image against the exact one {float(psnr(cut, exact)[0, 0]):.3f} dB"
        print(line, flush=True)


if __name__ == "__main__":
    main()
