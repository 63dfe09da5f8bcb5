"""The port's spans and counters (guidedvd3dgs_tpu_torch/utils/tracing.py),
on the CPU at toy sizes.

  - With no profiler a span is the one shared null context and records
    nothing, and `count` leaves COUNTS empty; a timed span still times.
  - Under torch.profiler one baseline and one guided trainer step record
    the `train.*` ranges inside "train.step"; `raster.instances` is the
    step's instance total, and `host.readbacks` counts every place where the
    step waits for the card: the binning's total (one a chain, inside
    "train.render"), SSIM's window, and, guided, the pseudo camera's three
    copies and VGG's mean and std; a densification counts its selections
    and KNN's constants.
  - A toy guided DDIM step, and a toy `cfg_model_output` + `ddim_step`,
    record the `ddim.*` ranges and the `nn.*` ranges of the models inside
    them.
  - Each per-layer metric of the benchmark that reads these ranges or
    counters returns its value from a hand-made trace view, and None when
    its label or counter is absent.
  - An oracle event still fills `event_phase_s`, and `--profile_dir`'s
    window writes the counts beside its trace.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from guidedvd3dgs_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from guidedvd3dgs_tpu_torch.diffusion import clip, resampler, schedules, unet3d, vae
from guidedvd3dgs_tpu_torch.diffusion.init import init_diffusion_params
from guidedvd3dgs_tpu_torch.diffusion.model import Conditioning, LatentDiffusionConfig, apply_model
from guidedvd3dgs_tpu_torch.diffusion.samplers import ddim, ddim_guidance
from guidedvd3dgs_tpu_torch.diffusion.synthesis import SynthesisConfig
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import make_guidance_fn, resize_guidance
from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.scene.cameras import Camera
from guidedvd3dgs_tpu_torch.scene.synthetic import write_gt_npz
from guidedvd3dgs_tpu_torch.train import baseline, guided
from guidedvd3dgs_tpu_torch.train.logging import maybe_profiler_trace
from guidedvd3dgs_tpu_torch.utils import tracing, vgg_loss

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
H, W, N = 32, 48, 400
TRAIN = ("train.render", "train.loss", "train.backward", "train.stats", "train.adam")


@pytest.fixture(autouse=True)
def fresh_counts():
    tracing.reset()
    yield
    tracing.reset()


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def ranges(prof):
    """{label: [event, ...]} of the program's ranges in a trace."""
    out = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX) and e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name[len(tracing.PREFIX):], []).append(e)
    return out


def enclosing(evt):
    """The labels of the program's ranges that enclose an event."""
    out, e = set(), evt.cpu_parent
    while e is not None:
        if e.name.startswith(tracing.PREFIX):
            out.add(e.name[len(tracing.PREFIX):])
        e = e.cpu_parent
    return out


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def test_no_profiler_no_range_and_no_count():
    assert not tracing.recording()
    a, b = tracing.span("train.render"), tracing.span("ddim.update")
    assert a is b
    with a, tracing.readback():
        tracing.count("raster.instances", 7)
    assert tracing.COUNTS == {}
    timed = {}
    with tracing.span("event.lift", into=timed, key="lift"):
        pass
    with tracing.span("event.wait", into=timed):
        pass
    assert set(timed) == {"lift", "event.wait"} and all(v >= 0.0 for v in timed.values())


def test_profiler_records_ranges_and_counts():
    def body():
        with tracing.span("outer.part"):
            with tracing.readback():
                torch.ones(3).sum().item()
            tracing.count("raster.instances", 5)

    prof, _ = profiled(body)
    got = ranges(prof)
    assert set(got) == {"outer.part", "host.readback"}
    assert enclosing(got["host.readback"][0]) == {"outer.part"}
    assert tracing.COUNTS == {"host.readbacks": 1, "raster.instances": 5}
    tracing.reset()
    assert tracing.COUNTS == {}


# ---------------------------------------------------------------------------
# trainer steps
# ---------------------------------------------------------------------------


def _scene(n_views=2, seed=0):
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(n_views):
        img = rng.uniform(size=(3, H, W)).astype(np.float32)
        cams.append(Camera(colmap_id=i, R=np.eye(3), T=np.array([0.1 * i, 0.0, 4.0]), FoVx=1.0, FoVy=0.8,
                           image=img, image_name=f"v{i}", uid=i))
    scene = SimpleNamespace(getTrainCameras=lambda: cams, getTestCameras=lambda: [], cameras_extent=2.0)
    p = dict(xyz=rng.normal(scale=0.8, size=(N, 3)), features_dc=rng.uniform(-1, 1, (N, 1, 3)),
             features_rest=rng.normal(scale=0.05, size=(N, 15, 3)), scaling=rng.uniform(-4, -2.5, (N, 3)),
             rotation=rng.normal(size=(N, 4)), opacity=rng.uniform(-2, 2, (N, 1)))
    return scene, {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}


def _state(params):
    return G.GaussianState.fresh(G.GaussianParams(**{k: v.clone() for k, v in params.items()}))


def _args():
    opt = OptimizationParams(densify_grad_threshold=1e10)
    return opt, PipelineParams(), ModelParams(sh_degree=3, white_background=False)


def _check_train_step(prof, stats, readbacks, extra=()):
    """The ranges of one step; `readbacks` {enclosing labels: count} of its
    host.readback ranges."""
    got = ranges(prof)
    assert set(TRAIN + ("train.step", "host.readback") + extra) <= set(got), sorted(got)
    for label in TRAIN:
        assert all(enclosing(e) == {"train.step"} for e in got[label]), label
    where = {tuple(sorted(enclosing(e))) for e in got["host.readback"]}
    assert where == set(readbacks) and len(got["host.readback"]) == len(readbacks), sorted(where)
    assert tracing.COUNTS == {"host.readbacks": sum(readbacks.values()), "raster.instances": stats.num_instances}
    assert stats.num_instances > 0
    return got


def test_baseline_step_records_the_train_ranges():
    scene, params = _scene()
    opt, pipe, mp = _args()
    t = baseline.BaselineTrainer(scene, _state(params), opt, pipe, mp)
    t.active_sh_degree = 3
    for it in (3001, 3002):  # both views' cameras on the device; no densification
        t.step(it)
    prof, stats = profiled(lambda: t.step(3003))
    _check_train_step(prof, stats, {("train.render", "train.step"): 1, ("train.loss", "train.step"): 1})


def _guided_trainer(scene, params, engine, vgg=True):
    opt, pipe, mp = _args()
    opt.start_sample_pseudo, opt.sample_pseudo_interval = 0, 1
    K = np.array([[W / (2 * np.tan(0.5)), 0, W / 2], [0, H / (2 * np.tan(0.4)), H / 2], [0, 0, 1]], np.float32)
    frozen = guided.FrozenRenderer(SimpleNamespace(**{k: v.clone() for k, v in params.items()}), 3)
    weights = vgg_loss.random_vgg19()
    vgg_fn = (lambda x, y: vgg_loss.vgg_perceptual_loss(weights, x, y)) if vgg else None
    return guided.GuidedTrainer(scene, _state(params), opt, pipe, mp, frozen, engine,
                                pcd_points=params["xyz"].numpy(), pcd_colors=np.zeros((N, 3), np.float32),
                                guidance_intrinsic=K, vgg_loss_fn=vgg_fn, hybrid_traj=True)


def test_guided_step_records_the_train_ranges():
    scene, params = _scene()
    t = _guided_trainer(scene, params, SimpleNamespace(video_length=4))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, -4.0]
    traj = np.stack([c2w] * 4)
    video = torch.rand(4, 3, H, W)
    t.finalize_diffusion_event(guided.PendingEvent(record=guided.EventRecord(
        0, traj, video, torch.zeros(4, 1, H, W), torch.ones(4, 1, H, W), "", None)))
    for it in (3001, 3002):
        t.step(it)
    prof, stats = profiled(lambda: t.step(3003))
    # the chain's total, SSIM's window (one range each), the pseudo
    # camera's three copies and VGG's two (one range each)
    got = _check_train_step(prof, stats, {("train.render", "train.step"): 1, ("train.loss", "train.step"): 1,
                                          ("train.step",): 3, ("train.loss", "train.step", "train.vgg"): 2},
                            extra=("train.vgg",))
    assert all(enclosing(e) == {"train.step", "train.loss"} for e in got["train.vgg"])


def test_densify_reads_its_selections_once_each():
    scene, params = _scene()
    opt, pipe, mp = _args()
    t = baseline.BaselineTrainer(scene, _state(params), opt, pipe, mp)
    t.state.max_radii2d.fill_(1.0)
    prof, _ = profiled(lambda: t.densify(3000))
    got = ranges(prof)
    assert all(enclosing(e) == {"train.densify"} for e in got["host.readback"])
    # clone and split read their selections (split twice), the split's
    # and the prune's removals their kept rows; KNN copies one constant
    # for each group of blocks in each of its 3 passes (one group here)
    assert len(got["host.readback"]) == tracing.COUNTS["host.readbacks"] == 5 + 3


def test_oracle_event_fills_the_phase_timers(tmp_path):
    scene, params = _scene()
    npz = tmp_path / "gt.npz"
    write_gt_npz(str(npz), {k: v.numpy() for k, v in params.items()})
    engine = guided.OracleDiffusionEngine(str(npz), video_length=4, height=H, width=W, sh_degree=3,
                                          device="cpu")
    t = _guided_trainer(scene, params, engine, vgg=False)
    t.init_view_geometry()
    prof, _ = profiled(lambda: t.run_diffusion_event(10))
    assert t.events_run == 1 and len(t.pseudo_stack) == 3
    assert all(t.event_phase_s[k] > 0 for k in ("pc_render", "frozen", "generate"))
    assert t.event_phase_s["lift"] == 0.0
    assert {"event.pc_render", "event.frozen", "event.artifacts", "event.generate"} <= set(ranges(prof))


def test_profile_window_writes_counts(tmp_path):
    scene, params = _scene()
    opt, pipe, mp = _args()
    t = baseline.BaselineTrainer(scene, _state(params), opt, pipe, mp)
    tracing.COUNTS["stale"] = 3
    prof = maybe_profiler_trace(str(tmp_path), True)
    stats = t.step(3001)
    maybe_profiler_trace(str(tmp_path), False, prof)
    counts = json.loads((tmp_path / "counts.json").read_text())
    # the binning's total, SSIM's window, the new camera's three copies
    assert counts["counts"] == {"host.readbacks": 5, "raster.instances": stats.num_instances}
    assert set(counts["launches"]) and all(v == 0 for v in counts["launches"].values())  # plain on the CPU
    assert (tmp_path / "trace.json").exists()


# ---------------------------------------------------------------------------
# DDIM steps
# ---------------------------------------------------------------------------

CTX, EMB, T = 32, 48, 2


@pytest.fixture(scope="module")
def toy_request():
    mcfg = LatentDiffusionConfig(
        unet=unet3d.UNetConfig(model_channels=32, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
                               num_head_channels=8, context_dim=CTX, temporal_length=T, text_context_len=7,
                               image_tokens_per_frame=4),
        vae=vae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=32,
                          z_channels=4))
    scfg = SynthesisConfig(
        ddim_steps=3, text_config=clip.TextConfig(width=CTX, heads=4, layers=2),
        vision_config=clip.VisionConfig(width=EMB, heads=4, layers=2, patch_size=32, image_size=224),
        resampler_config=resampler.ResamplerConfig(dim=CTX, depth=1, dim_head=8, heads=4, num_queries=4,
                                                   embedding_dim=EMB, output_dim=CTX, video_length=T))
    params = init_diffusion_params(mcfg, scfg, seed=3)
    g = torch.Generator().manual_seed(0)
    h = w = 8  # latents of 16 x 16 frames
    ctx = lambda: torch.randn(1, 7 + 4 * T, CTX, generator=g)  # noqa: E731
    concat = torch.randn(1, T, h, w, 4, generator=g)
    fs = torch.full((1,), 10, dtype=torch.int64)
    cond, uncond = Conditioning(ctx(), concat, fs), Conditioning(ctx(), concat, fs)
    sched = mcfg.schedule()
    pr = schedules.make_ddim_params(sched, 3, eta=1.0, method="uniform_trailing")
    bufs = resize_guidance(torch.rand(T, 3, 16, 16, generator=g), 16, 16,
                           masks=torch.ones(T, 1, 16, 16), depths=torch.ones(T, 1, 16, 16))
    x = torch.randn(1, T, h, w, 4, generator=g)
    noise = torch.randn(1, T, h, w, 4, generator=g)
    return SimpleNamespace(params=params, mcfg=mcfg, cond=cond, uncond=uncond, sched=sched, pr=pr,
                           gfn=make_guidance_fn(bufs), x=x, noise=noise)


def test_guided_step_records_the_ddim_ranges(toy_request):
    r = toy_request
    gcfg = ddim_guidance.GuidedSampleConfig(decode_chunk=1)
    prof, _ = profiled(lambda: ddim_guidance.guided_step(r.params, r.mcfg, r.sched, r.pr, r.cond, r.uncond, gcfg,
                                                         r.gfn, 1.0, r.x, 1, r.noise))
    got = ranges(prof)
    parts = ("ddim.pair_forward", "ddim.decode_grads", "ddim.pair_vjp", "ddim.update")
    assert set(parts) | {"nn.conv", "nn.linear", "nn.attention", "nn.group_norm"} <= set(got), sorted(got)
    for label in parts:
        assert all(not (enclosing(e) & set(parts)) for e in got[label]), label
    assert len(got["ddim.update"]) == 3  # the CFG output, the DDIM update, the guidance update
    for label in ("nn.conv", "nn.group_norm", "nn.attention", "nn.linear"):
        outer = [enclosing(e) & set(parts) for e in got[label]]
        assert all(len(o) == 1 for o in outer), label
        assert {"ddim.pair_forward", "ddim.pair_vjp"} <= set.union(*outer)
    assert {"ddim.decode_grads"} in [enclosing(e) & set(parts) for e in got["nn.conv"]]


def test_plain_step_records_the_ddim_ranges(toy_request):
    r = toy_request
    t = r.pr.timesteps[1].expand(1)

    def step():
        ap = lambda c: (lambda x_, t_: apply_model(r.params, r.mcfg, x_, t_, c))  # noqa: E731
        with torch.no_grad():
            mo, _ = ddim.cfg_model_output(ap(r.cond), ap(r.uncond), r.x, t, 7.5, 0.7)
            return ddim.ddim_step(r.sched, r.pr, 1, r.x, mo, r.noise)

    prof, _ = profiled(step)
    got = ranges(prof)
    assert {"ddim.pair_forward", "ddim.update", "nn.conv", "nn.linear", "nn.attention",
            "nn.group_norm"} <= set(got)
    assert "ddim.decode_grads" not in got and "ddim.pair_vjp" not in got
    assert len(got["ddim.pair_forward"]) == 1 and len(got["ddim.update"]) == 2
    assert all(enclosing(e) == {"ddim.pair_forward"} for e in got["nn.conv"])


# ---------------------------------------------------------------------------
# the per-layer metrics that read them
# ---------------------------------------------------------------------------

SPAN_METRICS = {"render_ms.train": "train.render", "loss_ms.train": "train.loss",
                "pair_forward_ms.ddim": "ddim.pair_forward", "decode_grads_ms.ddim": "ddim.decode_grads",
                "pair_vjp_ms.ddim": "ddim.pair_vjp", "conv_ms.ddim": "nn.conv", "attention_ms.ddim": "nn.attention"}
COUNTER_METRICS = {"readbacks_per_step.train": ("host.readbacks", 1.0),
                   "instances_per_step.train": ("raster.instances", 1e-6)}


def _metric(name):
    for p in (str(BENCH), str(BENCH.parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import spec as spec_mod
    from harness.trace import TraceView

    mod = spec_mod.load_module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")
    return mod, TraceView


def _view(TraceView, steps, label_s):
    return TraceView(steps=steps, window_s=1.0, busy_s=0.5, label_s=label_s, label_host_s={}, kernel_s={},
                     kernel_count={}, gaps=[])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_reads_its_label(name):
    mod, TraceView = _metric(name)
    assert not hasattr(mod, "SPANS")
    assert mod.read(_view(TraceView, 4, {SPAN_METRICS[name]: 0.02, "other": 1.0})) == pytest.approx(5.0)
    assert mod.read(_view(TraceView, 4, {"other": 1.0})) is None


@pytest.mark.parametrize("name", sorted(COUNTER_METRICS))
def test_counter_metric_reads_its_counter(name):
    mod, TraceView = _metric(name)
    counter, scale = COUNTER_METRICS[name]
    assert mod.read(_view(TraceView, 4, {})) is None
    tracing.COUNTS[counter] = 10
    assert mod.read(_view(TraceView, 4, {})) == pytest.approx(2.5 * scale)
