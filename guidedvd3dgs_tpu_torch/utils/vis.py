"""Image-grid visualisation helpers.

Counterpart of `guidedvd3dgs_tpu/utils/vis.py` (the reference's debug
plotter, utils/vis_utils.py:8-28): a two-row grid, images on top and
JET-coloured weight maps below (two blank tiles first), saved as one PNG.
Numpy only: the JET table is OpenCV's COLORMAP_JET, written out as its
piecewise-linear ramps, and the PNG goes through utils/image_io.py, so no
cv2 is needed. Channels-last (H, W, 3) float images in [0, 1].
"""

from __future__ import annotations

import numpy as np

from guidedvd3dgs_tpu_torch.utils.image_io import save_image


def make_grid(images: np.ndarray, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile (N, H, W, 3) images into one row (H + 2p, N (W + p) + p, 3), as
    torchvision.utils.make_grid(nrow=N)."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    out = np.full((h + 2 * padding, n * (w + padding) + padding, c), pad_value, np.float32)
    for i in range(n):
        x0 = padding + i * (w + padding)
        out[padding:padding + h, x0:x0 + w] = images[i]
    return out


def _jet_table() -> np.ndarray:
    """OpenCV's COLORMAP_JET as a (256, 3) uint8 RGB table: ramps of 4
    levels a step (its blue ramp ends on 1 at 159, where the line gives 2)."""
    i = np.arange(256)
    r = np.minimum(4 * i - 382, 1148 - 4 * i)
    g = np.minimum(4 * i - 128, 892 - 4 * i)
    b = np.minimum(4 * i + 128, 638 - 4 * i)
    b[159] = 1
    return np.clip(np.stack([r, g, b], 1), 0, 255).astype(np.uint8)


JET = _jet_table()


def colormap_jet(gray: np.ndarray) -> np.ndarray:
    """(H, W) in [0, 1] -> (H, W, 3) RGB jet colormap in [0, 1]."""
    u8 = (np.clip(np.asarray(gray, np.float32), 0.0, 1.0) * 255).astype(np.uint8)
    return JET[u8].astype(np.float32) / 255.0


def plot_images(images: np.ndarray, weight_map: np.ndarray, save_image_name: str) -> None:
    """Save a two-row debug grid. images: (N, H, W, 3) in [0, 1];
    weight_map: (N - 2, H, W) of any range, min-max normalised together.
    Row 1 the images; row 2 two blank tiles, then the coloured maps."""
    images = np.asarray(images, np.float32)
    weight_map = np.asarray(weight_map, np.float32)
    n, h, w, _ = images.shape
    lo, hi = weight_map.min(), weight_map.max()
    norm = (weight_map - lo) / max(hi - lo, 1e-12)
    colored = np.stack([colormap_jet(m) for m in norm], 0)
    blanks = np.ones((2, h, w, 3), np.float32)
    combined = np.concatenate([make_grid(images), make_grid(np.concatenate([blanks, colored], 0))], axis=0)
    save_image((np.clip(combined, 0.0, 1.0) * 255).astype(np.uint8), save_image_name)
