"""The port's PNG codec and the numpy weight bridge."""

import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu_torch.convert import params_from_numpy
from guidedvd3dgs_tpu_torch.scene.camera_utils import compute_resolution, image_to_chw
from guidedvd3dgs_tpu_torch.utils import image_io

torch.set_num_threads(2)


def _test_image(h=37, w=53, seed=0):
    """Smooth gradients, noise and flat areas, so every filter type finds
    work."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1).astype(np.uint8)
    img[: h // 2, : w // 2] = rng.integers(0, 256, (h // 2, w // 2, 3), dtype=np.uint8)
    img[h // 2 :, w // 2 :] = 77
    return img


def test_png_round_trip(tmp_path):
    img = _test_image()
    path = str(tmp_path / "a.png")
    image_io.save_image(img.transpose(2, 0, 1).astype(np.float32) / 255.0, path)
    np.testing.assert_array_equal(image_io.load_image(path), img)
    # the same file through another decoder
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], img)
    # float rounding is half up, as the reference writer's
    image_io.save_image(np.full((2, 3), 0.5 / 255.0, np.float32), path)
    assert (image_io.load_image(path) == 1).all()


def _filter_types(path):
    """The set of row filter types in a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, stride = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, _h, _d, ctype = struct.unpack(">IIBB", body[:10])
            stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    return set(zlib.decompress(idat)[::stride])


FILTER_IDS = {"NONE": {0}, "SUB": {1}, "UP": {2}, "AVG": {3}, "PAETH": {4}, "ALL": {0, 1, 2, 3, 4}}


@pytest.mark.parametrize("flt", list(FILTER_IDS))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_files_written_by_cv2(tmp_path, flt, channels):
    flag = cv2.IMWRITE_PNG_ALL_FILTERS if flt == "ALL" else getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}")
    img = _test_image(seed=channels)
    if channels == 1:
        img = img[..., :1]
    elif channels == 4:
        img = np.concatenate([img, img[..., :1] // 2 + 7], -1)
    path = str(tmp_path / "cv.png")
    bgr = img if channels == 1 else img[..., [2, 1, 0] + ([3] if channels == 4 else [])]
    assert cv2.imwrite(path, np.ascontiguousarray(bgr), [cv2.IMWRITE_PNG_FILTER, flag])
    if flt != "ALL":  # libpng's adaptive choice varies with the content
        assert _filter_types(path) == FILTER_IDS[flt]
    np.testing.assert_array_equal(image_io.read_png(path), img)
    expect_rgb = np.repeat(img, 3, -1) if channels == 1 else img[..., :3]
    np.testing.assert_array_equal(image_io.load_image(path), expect_rgb)


def test_params_from_numpy_activations_match_reference():
    rng = np.random.default_rng(2)
    n = 257
    leaves = {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(size=(n, 15, 3)).astype(np.float32),
        "scaling": rng.uniform(-6, 1, (n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        "opacity": rng.normal(scale=3, size=(n, 1)).astype(np.float32),
    }
    ref = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    port = params_from_numpy(leaves)
    assert port.num_gaussians == n
    for name, p, r in (
        ("scaling", port.get_scaling, JG.get_scaling(ref)),
        ("rotation", port.get_rotation, JG.get_rotation(ref)),
        ("opacity", port.get_opacity, JG.get_opacity(ref)),
        ("features", port.get_features, JG.get_features(ref)),
    ):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(port.xyz.detach().numpy(), leaves["xyz"])


@pytest.mark.parametrize("args_resolution", [2, 4])
def test_resolution_policy_downscale_close_to_pil(args_resolution):
    """The reference loader resizes with PIL; the port's resample of a
    downscale (other cubic coefficient) stays within 6 levels of it, and
    within 1 level on 99.9% of the samples."""
    from PIL import Image

    img = _test_image(h=120, w=200, seed=4)
    res = compute_resolution(200, 120, args_resolution, 1.0)
    assert res == (200 // args_resolution, 120 // args_resolution)
    port = image_to_chw(img, res) * 255.0
    ref = np.asarray(Image.fromarray(img).resize(res), np.float32).transpose(2, 0, 1)
    diff = np.abs(port - ref)
    assert diff.max() <= 6.0 + 1e-3
    assert (diff <= 1.0 + 1e-3).mean() >= 0.999
    np.testing.assert_array_equal(image_to_chw(img, (200, 120)) * 255.0, img.transpose(2, 0, 1))
