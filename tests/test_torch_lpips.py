"""LPIPS and the metrics CLI's LPIPS columns, port against reference, on the CPU.

Random weights (`random_lpips_state_dicts`, seeded numpy) are written in
the torchvision backbone and LPIPS v0.1 `lin` file layouts to a directory
that both packages' `load_lpips` read. On seeded random image pairs
(2, 3, 40, 48) the port's alex, vgg and squeeze LPIPS agree with JAX's
`lpips_apply` within rtol 1e-4 / atol 1e-6 (float32 convolutions summed in
another order), and read exactly 0 for identical images. Without files
both return None. The port's metrics.py writes the same LPIPS and
LPIPS_ALEX columns (means and per view) as the reference's metrics.py on
the same renders, within the same tolerance, and null without weights.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import metrics as root_metrics
from guidedvd3dgs_tpu_torch import metrics as port_metrics
from guidedvd3dgs_tpu_torch.utils import lpips as plpips
from guidedvd3dgs_tpu_torch.utils.image_io import save_image

# the module: the package's __init__ exports a function of the same name
jlpips = importlib.import_module("guidedvd3dgs_tpu.metrics.lpips")
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    """A weights directory with all three nets, and no other place to look."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.delenv("LPIPS_WEIGHTS_DIR", raising=False)
    d = tmp_path / "lpips"
    plpips.write_random_lpips(str(d), seed=3, nets=("alex", "vgg", "squeeze"))
    return str(d)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_reference(weights, net):
    port = plpips.load_lpips(net, weights)
    ref = jlpips.load_lpips(net, weights)
    assert port is not None and ref is not None
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(2, 3, 40, 48)).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.1, size=x.shape), 0, 1).astype(np.float32)
    if net == "alex":
        x, y = x * 2 - 1, y * 2 - 1
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        same = port(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    want = np.asarray(jlpips.lpips_apply(ref, x, y))
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(same, np.zeros(2, np.float32))


def test_load_lpips_without_files_is_none(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.delenv("LPIPS_WEIGHTS_DIR", raising=False)
    (tmp_path / "empty").mkdir()
    for net in ("alex", "vgg"):
        assert plpips.load_lpips(net, str(tmp_path / "empty")) is None
        assert jlpips.load_lpips(net, str(tmp_path / "empty")) is None


def _renders(root, n=3):
    rng = np.random.default_rng(12)
    for method in ("ours_30", "ours_60"):
        for sub in ("renders", "gt"):
            os.makedirs(root / "test" / method / sub, exist_ok=True)
        for i in range(n):
            gt = rng.uniform(size=(3, 36, 44)).astype(np.float32)
            save_image(gt, str(root / "test" / method / "gt" / f"{i:05d}.png"))
            save_image(np.clip(gt + rng.normal(scale=0.08, size=gt.shape), 0, 1),
                       str(root / "test" / method / "renders" / f"{i:05d}.png"))


def test_metrics_cli_writes_the_reference_lpips_columns(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", weights)
    for name in ("port", "ref"):
        _renders(tmp_path / name)
    port_metrics.main(["-m", str(tmp_path / "port"), "--device", "cpu"])
    root_metrics.evaluate([str(tmp_path / "ref")])
    for fname in ("results.json", "per_view.json"):
        got = json.loads((tmp_path / "port" / fname).read_text())
        want = json.loads((tmp_path / "ref" / fname).read_text())
        assert got.keys() == want.keys() == {"ours_30", "ours_60"}
        for method in want:
            for key in ("LPIPS", "LPIPS_ALEX"):
                g, w = got[method][key], want[method][key]
                if isinstance(w, dict):
                    assert g.keys() == w.keys() and len(w) == 3
                    g, w = [g[k] for k in sorted(g)], [w[k] for k in sorted(w)]
                assert w is not None
                np.testing.assert_allclose(g, w, **TOL)


def test_metrics_cli_writes_null_without_weights(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.delenv("LPIPS_WEIGHTS_DIR", raising=False)
    _renders(tmp_path / "m", n=1)
    port_metrics.evaluate([str(tmp_path / "m")], device="cpu")
    assert "LPIPS weights not found" in capsys.readouterr().out
    res = json.loads((tmp_path / "m" / "results.json").read_text())["ours_30"]
    assert res["LPIPS"] is None and res["LPIPS_ALEX"] is None and res["PSNR"] > 10
