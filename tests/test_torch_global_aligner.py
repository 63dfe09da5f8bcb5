"""DUSt3R's global aligner, port against the JAX package, on the CPU.

The same numpy inputs go to JAX's optax/lax.scan aligner and the port's
autograd loop:
  - `init_state` from one seeded generator: equal arrays (the same draws in
    the same order), with and without the COLMAP presets;
  - the loss of a random state within rel 1e-5, and after 20 Adam
    iterations (no presets; then with presets) the loss within rel 1e-4 and
    every parameter within atol 2e-4 (20 steps of lr 0.01: Adam's
    normalised step magnifies float32 rounding near zero gradients);
  - JAX's known-answer test (tests/test_global_aligner.py:60, two views,
    preset poses and focals, perfect predictions, a corrupted depth start,
    300 iterations) in both packages: loss < 0.05, the median relative
    depth error < 0.1, the two depths within 1e-3 of each other.
Hazards covered here: confidences enter as log(conf) (the loss is fed raw
confidences in both packages), and preset poses and focals do not move at
all (bitwise).
"""

import jax.numpy as jnp
import numpy as np
import torch

from guidedvd3dgs_tpu.geometry import global_aligner as JGA
from guidedvd3dgs_tpu_torch.geometry import global_aligner as TGA

torch.set_num_threads(2)


def _problem(seed=0, v=3, h=6, w=8):
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(v) for j in range(v) if i != j]
    e = len(edges)
    pred_i = rng.normal(size=(e, h * w, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    pred_j = rng.normal(size=(e, h * w, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    conf_i = (1.0 + rng.random((e, h * w)) * 4).astype(np.float32)
    conf_j = (1.0 + rng.random((e, h * w)) * 4).astype(np.float32)
    c2w = np.stack([np.eye(4) for _ in range(v)])
    for k in range(v):
        c2w[k, :3, 3] = [0.3 * k, -0.1 * k, 0.05 * k]
    return edges, pred_i, pred_j, conf_i, conf_j, c2w, h, w


def _states(preset: bool, seed=0):
    edges, pred_i, pred_j, conf_i, conf_j, c2w, h, w = _problem(seed)
    kw = dict(preset_c2w=c2w, preset_focals=np.full(3, 9.0)) if preset else {}
    jcfg = JGA.AlignerConfig(height=h, width=w, pose_preset=preset, focal_preset=preset)
    tcfg = TGA.AlignerConfig(height=h, width=w, pose_preset=preset, focal_preset=preset)
    js = JGA.init_state(jcfg, 3, edges, pred_i, np.random.default_rng(7), **kw)
    ts = TGA.init_state(tcfg, 3, edges, pred_i, np.random.default_rng(7), **kw)
    return (edges, pred_i, pred_j, conf_i, conf_j), jcfg, tcfg, js, ts


def test_init_state_matches_jax():
    for preset in (False, True):
        _, _, _, js, ts = _states(preset)
        for name in JGA.AlignerState._fields:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


def test_loss_and_20_iterations_match_jax():
    for preset in (False, True):
        (edges, pi, pj, ci, cj), jcfg, tcfg, js, ts = _states(preset)
        ei = np.array([i for i, _ in edges])
        ej = np.array([j for _, j in edges])
        lj = float(JGA.alignment_loss(js, jcfg, jnp.asarray(pi), jnp.asarray(pj), jnp.log(jnp.asarray(ci)),
                                      jnp.log(jnp.asarray(cj)), jnp.asarray(ei), jnp.asarray(ej)))
        lt = float(TGA.alignment_loss(ts, tcfg, torch.from_numpy(pi), torch.from_numpy(pj),
                                      torch.log(torch.from_numpy(ci)), torch.log(torch.from_numpy(cj)),
                                      torch.from_numpy(ei), torch.from_numpy(ej)))
        assert abs(lt - lj) <= 1e-5 * abs(lj)
        js2, jl = JGA.global_align(js, jcfg, jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(ci), jnp.asarray(cj),
                                   edges, niter=20)
        ts2, tl = TGA.global_align(ts, tcfg, torch.from_numpy(pi), torch.from_numpy(pj), torch.from_numpy(ci),
                                   torch.from_numpy(cj), edges, niter=20)
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
        for name in TGA.AlignerState._fields:
            np.testing.assert_allclose(getattr(ts2, name).numpy(), np.asarray(getattr(js2, name)), atol=2e-4)
        if preset:  # the presets do not move, bitwise
            assert torch.equal(ts2.im_poses, ts.im_poses) and torch.equal(ts2.im_focals, ts.im_focals)
        else:
            assert not torch.equal(ts2.im_poses, ts.im_poses)


def _known_scene(h=8, w=12, f=20.0):
    rng = np.random.default_rng(0)
    c2w = np.stack([np.eye(4), np.eye(4)])
    c2w[1, :3, 3] = [0.4, 0.0, 0.0]
    depth = rng.uniform(2.0, 4.0, size=(2, h, w)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    def unproject(v):
        d = depth[v]
        cam = np.stack([(xx - w / 2.0) * d / f, (yy - h / 2.0) * d / f, d], -1).reshape(-1, 3)
        return cam @ c2w[v, :3, :3].T + c2w[v, :3, 3]

    pts = [unproject(0), unproject(1)]

    def in_frame(pw, k):
        w2c = np.linalg.inv(c2w[k])
        return pw @ w2c[:3, :3].T + w2c[:3, 3]

    pred_i = np.stack([in_frame(pts[0], 0), in_frame(pts[1], 1)]).astype(np.float32)
    pred_j = np.stack([in_frame(pts[1], 0), in_frame(pts[0], 1)]).astype(np.float32)
    return c2w, depth, pred_i, pred_j, f


def test_preset_pose_depth_recovery_both_packages():
    h, w = 8, 12
    c2w, depth, pred_i, pred_j, f = _known_scene(h, w)
    edges = [(0, 1), (1, 0)]
    conf = np.full((2, h * w), 5.0, np.float32)

    jcfg = JGA.AlignerConfig(height=h, width=w, pose_preset=True, focal_preset=True)
    js = JGA.init_state(jcfg, 2, edges, pred_i, np.random.default_rng(2), preset_c2w=c2w,
                        preset_focals=np.array([f, f]))
    js = js._replace(im_depth=js.im_depth + 0.3)
    js, jl = JGA.global_align(js, jcfg, jnp.asarray(pred_i), jnp.asarray(pred_j), jnp.asarray(conf),
                              jnp.asarray(conf), edges, niter=300, lr=0.02)
    jout = JGA.aligner_outputs(js, jcfg)

    tcfg = TGA.AlignerConfig(height=h, width=w, pose_preset=True, focal_preset=True)
    ts0 = TGA.init_state(tcfg, 2, edges, pred_i, np.random.default_rng(2), preset_c2w=c2w,
                         preset_focals=np.array([f, f]))
    ts0 = ts0._replace(im_depth=ts0.im_depth + 0.3)
    ts, tl = TGA.global_align(ts0, tcfg, torch.from_numpy(pred_i), torch.from_numpy(pred_j),
                              torch.from_numpy(conf), torch.from_numpy(conf), edges, niter=300, lr=0.02)
    tout = TGA.aligner_outputs(ts, tcfg)

    for loss, out in ((float(jl), {k: np.asarray(v) for k, v in jout.items()}),
                      (float(tl), {k: v.numpy() for k, v in tout.items()})):
        assert loss < 0.05, loss
        np.testing.assert_allclose(out["c2w"], c2w, atol=1e-5)
        np.testing.assert_allclose(out["focals"], [f, f], rtol=1e-6)
        rel_err = np.abs(out["depth"] - depth) / depth
        assert float(np.median(rel_err)) < 0.1, float(np.median(rel_err))
    np.testing.assert_allclose(tout["depth"].numpy(), np.asarray(jout["depth"]), atol=1e-3)
    assert torch.equal(ts.im_poses, ts0.im_poses) and torch.equal(ts.im_focals, ts0.im_focals)
