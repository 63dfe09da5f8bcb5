"""8-bit PNG reading and writing with the standard library.

Counterpart of `guidedvd3dgs_tpu/utils/video.py::save_image` and
`load_image`, without cv2 or PIL: the encoder writes 8-bit RGB with filter
type 0 and zlib; the decoder reads 8-bit gray, gray+alpha, RGB, RGBA and
palette images with any of the five PNG row filters (not interlaced).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 by rounding half up; uint8 passes through."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def save_image(img: np.ndarray, path: str) -> None:
    """img: (3, H, W), (H, W, 3) or (H, W), float in [0, 1] or uint8."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(to_uint8(img))))


def save_images(images, paths) -> None:
    """save_image of each image to its path, encoded on a thread pool
    (zlib releases the interpreter lock)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(save_image, images, paths))


def _unfilter_slow(ft: int, line: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) rows: sequential along the row."""
    cur = bytearray(line)
    n = len(cur)
    if ft == 3:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        return cur
    for i in range(n):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with the file's own channels
    (palette images expand to RGB)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat, palette, ihdr = [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth}, color type {ctype}, interlace {interlace} not supported"
        )
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (stride + 1)]
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prev
        elif ft in (3, 4):
            cur = np.frombuffer(_unfilter_slow(ft, line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = cur
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        img = palette[img[..., 0]]
    return img


def png_size(path: str):
    """(width, height) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 with the file's own channels."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def load_image(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3) uint8 RGB (gray is expanded, alpha
    dropped)."""
    img = read_png(path)
    if img.shape[2] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
