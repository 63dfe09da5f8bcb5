"""The port's Gaussian state operations against the reference's.

Same numpy inputs through the reference (`guidedvd3dgs_tpu/models/
gaussians.py`, fixed capacity with an active prefix) and the port (exact
row counts). Tolerances:
  - dist_knn3: the same 3 neighbours for >= 99.9% of 5,000 points, and
    mean squared distances within 1e-5 relative where they do;
  - adam_step and reset_opacity: atol 1e-6;
  - densify_and_prune with the reference's split noise fed to the port:
    the same rows in the same order, atol 1e-6;
  - a reference checkpoint read by the port gives its active rows exactly,
    and the reference reads the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.ops.knn import dist_knn3 as jax_dist_knn3
from guidedvd3dgs_tpu.train import checkpoint as jax_ckpt
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.ops.knn import dist_knn3
from guidedvd3dgs_tpu_torch.train import checkpoint

torch.set_num_threads(2)

CAP = 1024


def assert_state_close(port: G.GaussianState, ref, atol=1e-6):
    ref = jax.device_get(ref)
    act = np.asarray(ref.active)
    assert act[: act.sum()].all()  # a compacted prefix
    assert port.num_gaussians == int(act.sum())
    for name in G.PARAM_NAMES:
        for grp_p, grp_r in ((port.params.tensors(), ref.params), (port.adam_m, ref.adam_m),
                             (port.adam_v, ref.adam_v)):
            np.testing.assert_allclose(grp_p[name].numpy(), np.asarray(getattr(grp_r, name))[act],
                                       atol=atol, rtol=0, err_msg=name)
    for name in ("confidence", "max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name))[act],
                                   atol=atol, rtol=0, err_msg=name)
    assert port.step == int(ref.step)


def test_dist_knn3_matches_reference():
    rng = np.random.default_rng(0)
    n = 5000
    pts = (rng.normal(size=(n, 3)) * np.array([2.0, 1.0, 0.5])).astype(np.float32)
    pts[100:150] = pts[:50]  # exact duplicates, as clones make
    full = np.zeros((8192, 3), np.float32)
    full[:n] = pts
    d_ref, i_ref = jax_dist_knn3(jnp.asarray(full), jnp.asarray(np.arange(8192) < n))
    d_ref, i_ref = np.asarray(d_ref)[:n], np.asarray(i_ref)[:n]
    d, i = dist_knn3(torch.from_numpy(pts))
    same = (np.sort(i.numpy(), 1) == np.sort(i_ref, 1)).all(1)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(d.numpy()[same], d_ref[same], rtol=1e-5)


def random_state(seed, n=300):
    """A reference state with a cluster, a few large isolated outliers, a
    spread of scales, opacities and densification statistics."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    pts[:6] = rng.choice([-6.0, 6.0], size=(6, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    st = JG.create_from_pcd(pts, cols, capacity=CAP)
    p = st.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:n] = rng.uniform(-5.0, -0.5, (n, 3)).astype(np.float32)
    scaling[:6] = np.log(0.9)
    opacity = np.asarray(p.opacity).copy()
    opacity[:n] = rng.uniform(-7.0, 3.0, (n, 1)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:n] = rng.normal(size=(n, 4)).astype(np.float32)
    frest = np.asarray(p.features_rest).copy()
    frest[:n] = rng.normal(scale=0.1, size=(n, 15, 3)).astype(np.float32)
    accum = np.zeros((CAP, 1), np.float32)
    denom = np.zeros((CAP, 1), np.float32)
    accum[:n] = rng.uniform(0, 2e-3, (n, 1))
    denom[:n] = rng.integers(0, 4, (n, 1))
    radii = np.zeros((CAP,), np.float32)
    radii[:n] = rng.uniform(0, 40, n)
    mom = lambda: jax.tree.map(lambda a: jnp.asarray(rng.normal(scale=1e-3, size=a.shape) *
                                                     (np.arange(CAP) < n).reshape((-1,) + (1,) * (a.ndim - 1)),
                                                     jnp.float32), st.params)
    return st._replace(
        params=p._replace(scaling=jnp.asarray(scaling), opacity=jnp.asarray(opacity),
                          rotation=jnp.asarray(rotation), features_rest=jnp.asarray(frest)),
        adam_m=mom(), adam_v=jax.tree.map(jnp.abs, mom()), step=jnp.int32(3),
        xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom), max_radii2d=jnp.asarray(radii),
    )


def test_adam_step_matches_reference():
    st = random_state(1)
    rng = np.random.default_rng(2)
    port = state_from_numpy(jax.device_get(st))
    lrs = (1.6e-4, 0.0025, 0.0025 / 20, 0.05, 0.005, 0.001)
    for _ in range(2):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(scale=1e-2, size=a.shape), jnp.float32),
                             st.params)
        st = JG.adam_step(st, grads, JG.LearningRates(*map(jnp.float32, lrs)))
        act = np.asarray(st.active)
        G.adam_step(port, {k: torch.from_numpy(np.asarray(getattr(grads, k))[act]) for k in G.PARAM_NAMES},
                    G.LearningRates(*lrs))
    assert_state_close(port, st)


def test_reset_opacity_matches_reference():
    st = random_state(3)
    port = state_from_numpy(jax.device_get(st))
    G.reset_opacity(port)
    assert_state_close(port, JG.reset_opacity(st))


@pytest.mark.parametrize("proximity,prune,max_screen", [(True, True, 0.0), (False, True, 25.0),
                                                        (True, False, 0.0)])
def test_densify_and_prune_matches_reference(proximity, prune, max_screen):
    st = random_state(4)
    port = state_from_numpy(jax.device_get(st))
    cfg = JG.DensifyConfig(grad_threshold=2e-4, min_opacity=0.005, extent=0.5,
                           max_screen_size=max_screen, percent_dense=0.05, dist_thres=10.0,
                           prune_enabled=prune, proximity_enabled=proximity)
    key = jax.random.key(40)
    ref = JG.densify_and_prune(st, key, cfg)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (CAP, 3))) for i in range(2)]))
    G.densify_and_prune(port, G.DensifyConfig(*cfg), noise=noise)
    n_ref = int(np.asarray(ref.active).sum())
    assert n_ref != 300  # the event changed the set
    assert_state_close(port, ref)


def test_reference_checkpoint_read_by_port(tmp_path):
    st = random_state(5)
    path = str(tmp_path / "chkpnt12.ckpt")
    jax_ckpt.save_checkpoint(path, st, 12)
    port, it = checkpoint.load_checkpoint(path)
    assert it == 12
    assert_state_close(port, st, atol=0.0)
    # and back: the reference reads the port's checkpoint
    path2 = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path2, port, 13)
    back, it2 = jax_ckpt.load_checkpoint(path2, st)
    assert it2 == 13
    assert_state_close(port, back, atol=0.0)
