"""The port's guided step on the B-camera chain against the JAX package's
two trainers: `train_scan` (its CLI's default: every span between
schedule events one scan, the train and pseudo views one chain,
`rasterize_tiles_multi`) and `step` (each view its own render), on the CPU.

The scene of tests/test_torch_guided_densify.py (three 40x40 views, a
96-point anisotropic start, the mock engine at 5 frames, SH degree 0,
the reference's split noise) on the tile rasterizer, JAX's in interpret
mode with both packings off: iterations 1-21, pseudo views from the
first event on (the event after step 1), densify events at 5 and 10, an
opacity reset at 12, a second event at 16. The port's trainer steps; its
guided steps with a pseudo view render both views as one chain.

The Gaussian counts are equal at every boundary of JAX's scan (what its
logger reads there); at the end the parameters and xyz_gradient_accum
are within 1e-4 of their largest magnitude, denom and max_radii2d equal
(tests/test_torch_train_guided.py's tolerances), against either JAX
trainer; JAX's scan and step agree within the same bound.
"""

import jax
import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu.models import gaussians as JG
from guidedvd3dgs_tpu.ops import raster_tiles as jax_raster_tiles
from guidedvd3dgs_tpu.ops import tiling as jax_tiling
from guidedvd3dgs_tpu.train import guided as jg
from guidedvd3dgs_tpu_torch.convert import state_from_numpy
from guidedvd3dgs_tpu_torch.models.gaussians import PARAM_NAMES
from guidedvd3dgs_tpu_torch.scene import cameras as port_cameras
from guidedvd3dgs_tpu_torch.train import guided as pg

from helpers import activated, random_gaussians
from test_train_baseline import FakeModelParams, FakePipe, FakeScene, make_synthetic
from test_train_guided import GuidedOpt, _intrinsic

torch.set_num_threads(2)

CAPACITY = 2048
ITERS = 21
TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_exact():
    prev = jax_raster_tiles._INTERPRET[0]
    jax_raster_tiles.set_interpret(True)
    jax_tiling.set_pack_fields(False)
    jax_raster_tiles.set_pack_grads(False)
    yield
    jax_raster_tiles.set_interpret(prev)
    jax_tiling.set_pack_fields(True)
    jax_raster_tiles.set_pack_grads(True)


def _opt():
    return GuidedOpt(iterations=ITERS, start_sample_pseudo=0, end_sample_pseudo=ITERS + 5,
                     densification_interval=5, densify_from_iter=2, prune_from_iter=2, densify_until_iter=12,
                     densify_grad_threshold=1e-6, opacity_reset_interval=12, guidance_vd_iter=15,
                     position_lr_max_steps=ITERS + 10)


def _jax_split_noise(iteration):
    key = jax.random.key(iteration)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (CAPACITY, 3))) for i in range(2)]))


class _Counts:
    """The logger JAX's train_scan writes at each boundary: its counts."""

    def __init__(self):
        self.at = {}

    def scalars(self, step, values, prefix=""):
        if "total_points" in values:
            self.at[int(step)] = int(values["total_points"])


def _start():
    cams = make_synthetic()
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=1.2, size=(96, 3)).astype(np.float32)
    cols = rng.uniform(size=(96, 3)).astype(np.float32)
    jstate = JG.create_from_pcd(pts, cols, capacity=CAPACITY)
    p = jstate.params
    scaling = np.asarray(p.scaling).copy()
    scaling[:96] += rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    rotation = np.asarray(p.rotation).copy()
    rotation[:96] = rng.normal(size=(96, 4)).astype(np.float32)
    jstate = jstate._replace(params=p._replace(scaling=jax.numpy.asarray(scaling),
                                               rotation=jax.numpy.asarray(rotation)))
    gt_parts = activated(*random_gaussians(n=80, seed=42))
    gt_state = JG.create_from_pcd(np.asarray(gt_parts[0]), np.ones((80, 3)) * 0.5, capacity=128)
    return cams, pts, cols, jstate, gt_state


def _jax_trainer():
    cams, pts, cols, jstate, gt_state = _start()
    t = jg.GuidedTrainer(
        FakeScene(cams, extent=3.0), jstate, _opt(), FakePipe(raster_backend="tiles"),
        FakeModelParams(sh_degree=0), frozen=jg.FrozenRenderer(gt_state, sh_degree=0, backend="dense"),
        engine=jg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=_intrinsic(cams[0]))
    t.init_trajectory_pool()
    return t


def _port_trainer():
    cams, pts, cols, jstate, gt_state = _start()
    pcams = [port_cameras.Camera(colmap_id=0, R=c.R, T=c.T, FoVx=c.FoVx, FoVy=c.FoVy, image=c.image)
             for c in cams]
    t = pg.GuidedTrainer(
        FakeScene(pcams, extent=3.0), state_from_numpy(jax.device_get(jstate)), _opt(),
        FakePipe(raster_backend="tiles"), FakeModelParams(sh_degree=0),
        frozen=pg.FrozenRenderer(state_from_numpy(jax.device_get(gt_state)).params, 0, backend="dense"),
        engine=pg.MockDiffusionEngine(video_length=5, height=40, width=40),
        pcd_points=pts, pcd_colors=cols, guidance_intrinsic=_intrinsic(cams[0]))
    t.split_noise = _jax_split_noise
    t.init_trajectory_pool()
    return t


def _jax_final(t):
    st = jax.device_get(t.state)
    act = np.asarray(st.active)
    out = {n: np.asarray(getattr(st.params, n))[act] for n in PARAM_NAMES}
    out.update(xyz_gradient_accum=np.asarray(st.xyz_gradient_accum)[act], denom=np.asarray(st.denom)[act],
               max_radii2d=np.asarray(st.max_radii2d)[act])
    return out


def _assert_close(got, want, what):
    for name in PARAM_NAMES + ("xyz_gradient_accum",):
        err = np.abs(got[name] - want[name]).max() / max(np.abs(want[name]).max(), 1e-30)
        assert err <= TOL, (what, name, err)
    for name in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{what}: {name}")


def test_guided_chain_matches_jax_train_scan_and_step(monkeypatch):
    chains = []  # (cameras, with autograd) of each chain the port renders
    multi = pg.render_gaussians_multi

    def counted(params, cams, *args, **kwargs):
        chains.append((len(cams), torch.is_grad_enabled()))
        return multi(params, cams, *args, **kwargs)

    monkeypatch.setattr(pg, "render_gaussians_multi", counted)
    scan = _jax_trainer()
    counts = _Counts()
    scan.attach_logger(counts)
    scan.train_scan(iterations=ITERS, log_every=1)

    step = _jax_trainer()
    port = _port_trainer()
    step_counts, port_counts = {}, {}
    for it in range(1, ITERS + 1):
        step_counts[it] = step.step(it).num_active
        port_counts[it] = port.step(it).num_active
        jp, pp = float(step.last_metrics["pseudo_l1"]), float(port.last_metrics["pseudo_l1"])
        assert abs(pp - jp) <= TOL, (it, pp, jp)
    assert scan.events_run == step.events_run == port.events_run == 2
    # each step one chain: step 1 of its train view, steps 2-21 with a pseudo view of two
    assert [c for c in chains if c[1]] == [(1, True)] + [(2, True)] * (ITERS - 1), chains
    # each boundary of the scan: events (1, 16), densify (5, 10), the reset (12), the end
    assert {1, 5, 10, 12, 16, ITERS} <= set(counts.at), sorted(counts.at)
    for it, n in counts.at.items():
        assert port_counts[it] == step_counts[it] == n, (it, port_counts[it], step_counts[it], n)
    assert port_counts[10] > port_counts[1]  # the densify events changed the count
    p = port.state
    got = {n: getattr(p.params, n).detach().numpy() for n in PARAM_NAMES}
    got.update(xyz_gradient_accum=p.xyz_gradient_accum.numpy(), denom=p.denom.numpy(),
               max_radii2d=p.max_radii2d.numpy())
    want_scan, want_step = _jax_final(scan), _jax_final(step)
    _assert_close(got, want_scan, "port against train_scan")
    _assert_close(got, want_step, "port against step")
    _assert_close(want_scan, want_step, "train_scan against step")
