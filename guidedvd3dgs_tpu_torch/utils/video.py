"""Video artifacts and their background writer.

Counterpart of `guidedvd3dgs_tpu/utils/video.py` (the reference's
`save_video`, third_party/ViewCrafter/utils_vc/pvd_utils.py:37-47): a
video is an mp4 (OpenCV's mp4v) where cv2 imports and its writer opens,
else a sequence of PNG frames in a directory named as the video without
its extension (the PNGs by the standard-library encoder of
`utils/image_io.py`, so no image library is needed).
`AsyncArtifactWriter` runs the encodes on one background thread, so that
they overlap training; its errors surface at `drain()`.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.utils.image_io import save_image, to_uint8


class AsyncArtifactWriter:
    """One background worker for artifact writes. Submissions carry host
    data (numpy arrays): the caller copies from the device first, so no
    device buffer outlives the event. A write that raises is recorded and
    re-raised at `drain()`, which also waits for every queued write."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._errs: list = []
        self._thread: Optional[threading.Thread] = None

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception as e:  # re-raised at drain()
                self._errs.append(e)

    def submit(self, fn, *args, **kwargs) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._q.put((fn, args, kwargs))

    def drain(self) -> None:
        """Wait for every queued write; raise the first recorded error."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._errs:
            errs, self._errs = self._errs, []
            raise RuntimeError(f"{len(errs)} artifact write(s) failed") from errs[0]


def video_u8(frames: torch.Tensor) -> np.ndarray:
    """(T, 3, H, W), (T, H, W, 3) or (T, H, W) in [0, 1] -> uint8 on the
    host, quantised on the tensor's device (a quarter of the bytes to copy)."""
    if frames.dim() == 4 and frames.shape[1] == 3:
        frames = frames.permute(0, 2, 3, 1)
    return (torch.clamp(frames.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def save_png_sequence(frames_u8: np.ndarray, dirpath: str) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for i, f in enumerate(frames_u8):
        save_image(f, os.path.join(dirpath, f"{i:03d}.png"))


def save_video(frames: np.ndarray, path: str, fps: int = 10) -> None:
    """frames: (T, H, W, 3) rgb or (T, H, W) gray, float in [0, 1] or
    uint8. An mp4 at `path`, or PNG frames in `path` without its extension
    where cv2 cannot write one."""
    arr = to_uint8(np.asarray(frames))
    if arr.ndim == 3:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = arr.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in arr:
                vw.write(np.ascontiguousarray(f[:, :, ::-1]))  # rgb -> bgr
            vw.release()
            return
    save_png_sequence(arr, os.path.splitext(path)[0])


def jet_u8(values: np.ndarray) -> np.ndarray:
    """uint8 (...) -> (..., 3) rgb by the JET colormap as OpenCV's
    COLORMAP_JET tabulates it: ramps of 4 levels a step (its table holds 1
    where the blue ramp gives 2 at index 159)."""
    i = np.asarray(values).astype(np.int32)
    ramps = (np.minimum(4 * i - 382, 1148 - 4 * i), np.minimum(4 * i - 128, 892 - 4 * i),
             np.minimum(4 * i + 128, 638 - 4 * i))
    return np.clip(np.stack(ramps, axis=-1), 0, 255).astype(np.uint8)


def plot_image_grid(rows: Sequence[np.ndarray], path: str,
                    weights: Optional[Sequence[Optional[np.ndarray]]] = None) -> None:
    """Image rows ((3, H, W), (H, W, 3) or (H, W), float in [0, 1] or
    uint8) stacked top to bottom into one PNG at `path`; after row i its
    weight map weights[i] (H, W), where given, min-max normalised and
    JET-coloured (reference utils/vis_utils.py:8-28, which colours with
    cv2)."""
    tiles = []
    for i, row in enumerate(rows):
        row = np.asarray(row)
        if row.ndim == 3 and row.shape[0] in (1, 3):
            row = np.transpose(row, (1, 2, 0))
        if row.ndim == 2:
            row = row[..., None]
        if row.shape[-1] == 1:
            row = np.repeat(row, 3, axis=-1)
        tiles.append(to_uint8(row))
        if weights is not None and i < len(weights) and weights[i] is not None:
            wmap = np.asarray(weights[i], np.float32)
            wmap = (wmap - wmap.min()) / max(float(wmap.max() - wmap.min()), 1e-8)
            tiles.append(jet_u8((wmap * 255).astype(np.uint8)))
    save_image(np.concatenate(tiles, axis=0), path)
