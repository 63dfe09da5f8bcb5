"""DUSt3R's network, port against the JAX package, on the CPU.

The port's modules (guidedvd3dgs_tpu_torch/geometry/dust3r.py) and JAX's
functional `dust3r_apply` take the same numpy weights, drawn by the port's
`init_params` with the state dict's exact key set (JAX raises on a missing
key), at a toy width: encoder 64 x 2 layers (4 heads), decoder 48 x 4
layers (4 heads), DPT hooks (0, 2, 3, 4), 32x48 images. Tolerances: RoPE
within 1e-6; pts3d within 1e-5 and conf within 1e-5 (float32, outputs of
order 0.1 and 2). Hazards covered here: the DPT upsamples are
align-corners (the pair forward), the LayerNorm eps is 1e-6, and
`jax.image.resize(..., "bilinear")` antialiases where it shrinks
(resize_for_dust3r, 640x480 -> 512x384, within 1e-5; back up to 480x640
within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from guidedvd3dgs_tpu.geometry import dust3r as JD
from guidedvd3dgs_tpu.geometry import pipeline as JP
from guidedvd3dgs_tpu_torch.geometry import dust3r as TD
from guidedvd3dgs_tpu_torch.geometry import pipeline as TP
from guidedvd3dgs_tpu_torch.utils.general import resize_bilinear

torch.set_num_threads(2)

TOY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4)


class _Recording(dict):
    """A dict that records the keys read through [] and get."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)


@pytest.fixture(scope="module")
def toy():
    params = TD.init_params(TD.Dust3rConfig(**TOY), seed=3)
    rng = np.random.default_rng(0)
    i1 = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    i2 = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    rec = _Recording({k: jnp.asarray(v) for k, v in params.items()})
    oj = JD.dust3r_apply(rec, JD.Dust3rConfig(**TOY), jnp.asarray(i1), jnp.asarray(i2))
    return params, i1, i2, oj, rec.read


def test_rope2d_matches_jax():
    rng = np.random.default_rng(1)
    tok = rng.normal(size=(2, 3, 12, 16)).astype(np.float32)
    pos = rng.integers(0, 9, size=(2, 12, 2))
    want = np.asarray(JD.rope2d(jnp.asarray(tok), jnp.asarray(pos), 100.0))
    got = TD.rope2d(torch.from_numpy(tok), torch.from_numpy(pos), 100.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pair_forward_matches_jax(toy):
    params, i1, i2, oj, _ = toy
    model = TD.from_params(params, TD.Dust3rConfig(**TOY))
    ot = TD.dust3r_apply(model, torch.from_numpy(i1), torch.from_numpy(i2))
    for j, t in zip(oj, ot):
        assert t["pts3d"].shape == (2, 32, 48, 3) and t["conf"].shape == (2, 32, 48)
        np.testing.assert_allclose(t["pts3d"].numpy(), np.asarray(j["pts3d"]), atol=1e-5)
        np.testing.assert_allclose(t["conf"].numpy(), np.asarray(j["conf"]), atol=1e-5)
        assert (t["conf"] > 1).all()  # conf = 1 + exp


def test_init_params_key_set(toy):
    """The key set is the module tree's state dict; JAX reads every key but
    refinenet4's first residual unit, which the reference builds and never
    calls (refinenet4 has no skip input)."""
    params, _, _, _, read = toy
    model = TD.AsymmetricCroCo3DStereo(TD.Dust3rConfig(**TOY))
    assert set(params) == set(model.state_dict())
    assert all(params[k].shape == tuple(v.shape) and params[k].dtype == np.float32
               for k, v in model.state_dict().items())
    unread = set(params) - read
    assert unread and all(".scratch.refinenet4.resConfUnit1." in k for k in unread), sorted(unread)
    assert all(m.eps == 1e-6 for m in model.modules() if isinstance(m, nn.LayerNorm))
    # the published width's hooks and the DPT head's key names
    assert TD.Dust3rConfig().hooks == (0, 6, 9, 12)
    assert "downstream_head2.dpt.act_postprocess.3.1.weight" in params
    assert "downstream_head1.dpt.scratch.layer4_rn.bias" not in params  # bias-free 3x3


def test_make_pairs_matches_jax():
    for n in (2, 3, 6):
        assert TP.make_pairs(n) == JP.make_pairs(n)
        assert len(TP.make_pairs(n)) == n * (n - 1)
    assert TP.make_pairs(5, "swin-2") == JP.make_pairs(5, "swin-2")


def test_resize_for_dust3r_antialias_matches_jax():
    """jax.image.resize's bilinear antialiases when it shrinks: 640x480 ->
    512x384 (and a crop to multiples of 16 at another aspect)."""
    rng = np.random.default_rng(2)
    for shape in ((480, 640, 3), (300, 500, 3)):
        img = rng.random(shape).astype(np.float32)
        want = JP.resize_for_dust3r(img)
        got = TP.resize_for_dust3r(img)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert TP.resize_for_dust3r(np.zeros((480, 640, 3), np.float32)).shape == (384, 512, 3)
    # and back up, as the DPT estimator's input and the engine's video take
    # it: the plain triangle (torch's antialiased kernel is 1.5e-5 off here)
    img = rng.random((2, 384, 512, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, 480, 640, 3), "bilinear"))
    np.testing.assert_allclose(resize_bilinear(torch.from_numpy(img), 480, 640).numpy(), want, atol=1e-6)
