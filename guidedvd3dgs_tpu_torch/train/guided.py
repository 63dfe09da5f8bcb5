"""The guided trainer (train_guidedvd) and its diffusion engines.

Counterpart of `guidedvd3dgs_tpu/train/guided.py`'s per-step path
(reference train_guidedvd.py:48-636), with the same semantics:
  * `FrozenRenderer`: the frozen baseline renders rgb / alpha / depth for
    any w2c + K (reference utils/easy_renderer.py:15-78), a trajectory in
    groups of five frames, each group one chain of the tile rasterizer
    (ops/raster_tiles.py::rasterize_tiles_multi) with exactly sized
    buffers (the JAX package's groups have a fixed capacity and pad the
    last group; the port's last group is short);
  * the trajectory pool (Eq. 7): per train view and each of 3 centre
    scales, a (phi, theta) grid of candidates rendered by the frozen
    model; the alpha < 0.7 mask eroded by 5; the largest unobserved areas
    below 0.1 H W kept (3, 2, 1 per scale), each interpolated into a
    trajectory (reference :121-298);
  * per iteration: the train view's loss plus `pseudo_cam_weight` times a
    pseudo view's L1 [+ SSIM], the pseudo view drawn half the time from
    the all-time stack (reference :343-381), the two views rendered as one
    chain as the JAX package's default trainer (`train_scan`) renders
    them; the densification statistics of both views in one (:403-416);
  * every `guidance_vd_iter` iterations a diffusion event: the scene's
    point cloud splatted along a pooled trajectory, the frozen model
    rendered along it, the engine's video, and a new pseudo stack of its
    frames but the first, a fifth of them promoted to the all-time stack
    (reference :431-636).
The engines: `ViewCrafterEngine` (the ViewCrafter stack with guidance,
reference utils/viewcrafter_wrapper.py:550-573, driven by the trainer as
the reference's), `MockDiffusionEngine` (the frozen renders with the holes
filled by the point-cloud render) and `OracleDiffusionEngine` (renders of
known ground-truth Gaussians: a perfect prior for validation runs).
Around each event, as the JAX package: the per-event videos (render0,
gs_render, its alpha and depth, diffusion0, the engine's per-step pred_x0
with save_pred_x0) under `<model>/diffusion_events/train_iter<N>/`, written
by a background writer drained at the end of `train`; the generated video
stored at the train resolution under `<model>/video_files_scale<s>/<view>/
<cand>.npz` (guidance_save_videos) and read back instead of generating
(guidance_videos_from_file); the two-renderer variant (`frozen_mask` picks
the pool and supplies the mask) and guidance_with_training_gs (the
guidance renders of the current training Gaussians); the VGG perceptual
pseudo term (`vgg_loss_fn`); exact checkpoints (train/guided_checkpoint.py);
with append_pcd_from_video_diffusion and a `depth_estimator`, each event's
unobserved pixels lifted to new Gaussians (guidance/depth_lift.py,
models/gaussians.py::add_points; reference train_guidedvd.py:569-612).
With `pipeline_guidance` the events lag one boundary, as the JAX
package's pipelined events (its guided.py:1103-1107, 1676-1683, 1698-1702,
1724-1733): an event is submitted at its boundary and finalized at the
next, so its device work (the renders, the artifacts, the engine's video)
runs on a worker thread and its own CUDA stream while the trainer steps;
the host draws stay on the trainer's thread in the reference's order.
Not carried from the reference: its lax.scan chunk trainer and device
pseudo-frame pool (the steps are its per-step semantics, which its chunks
keep), and its capacity regrowth.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.convert import params_from_numpy

from guidedvd3dgs_tpu_torch.diffusion.model import DiffusionParams, LatentDiffusionConfig, decode_video_frames
from guidedvd3dgs_tpu_torch.diffusion.samplers.ddim_guidance import GuidedSampleConfig
from guidedvd3dgs_tpu_torch.diffusion.synthesis import (
    SynthesisConfig,
    SynthesisNoise,
    encode_text_pair,
    image_guided_synthesis,
)
from guidedvd3dgs_tpu_torch.guidance import morphology as morph
from guidedvd3dgs_tpu_torch.guidance.depth_lift import lift_video_to_points
from guidedvd3dgs_tpu_torch.guidance import pose_math as pm
from guidedvd3dgs_tpu_torch.guidance.loss_guidance import (
    guidance_weight_schedule,
    make_guidance_fn,
    resize_guidance,
)
from guidedvd3dgs_tpu_torch.models import gaussians as G
from guidedvd3dgs_tpu_torch.models.render import RenderResult, render_gaussians, render_gaussians_multi
from guidedvd3dgs_tpu_torch.ops.point_splat import splat_points_world, visible_points_mask
from guidedvd3dgs_tpu_torch.ops.projection import RasterCamera
from guidedvd3dgs_tpu_torch.parallel.mesh import Mesh, device_scope
from guidedvd3dgs_tpu_torch.parallel.model_parallel import shard_params
from guidedvd3dgs_tpu_torch.scene.cameras import PseudoCamera, camera_from_w2c_K
from guidedvd3dgs_tpu_torch.scene.synthetic import GT_NPZ_KEYS
from guidedvd3dgs_tpu_torch.train.baseline import BaselineTrainer, StepStats, lrs_for
from guidedvd3dgs_tpu_torch.utils.general import resize_bilinear
from guidedvd3dgs_tpu_torch.utils.losses import l1_loss, psnr, ssim
from guidedvd3dgs_tpu_torch.utils.tracing import span
from guidedvd3dgs_tpu_torch.utils.video import AsyncArtifactWriter, save_video, video_u8


def resize_renders(video: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, H, W, C) frames at (height, width), bilinear as the reference's
    jax.image.resize (guided.py:561-564): antialiased on an axis that
    shrinks, the plain triangle on one that grows (utils/general.py::
    resize_bilinear)."""
    if video.shape[1:3] == (height, width):
        return video
    return resize_bilinear(video, height, width)


class DiffusionEngine(Protocol):
    """Produces a video from point-cloud renders along a trajectory."""

    def generate(
        self,
        pc_renders: torch.Tensor,  # (T, H, W, 3) in [0, 1]
        guidance_images: torch.Tensor,  # (T, 3, Hg, Wg)
        guidance_masks: torch.Tensor,  # (T, 1, Hg, Wg)
        guidance_depths: torch.Tensor,  # (T, 1, Hg, Wg)
        generator: Optional[torch.Generator] = None,
        no_guidance: bool = False,
        scale_guidance_weight: float = 1.0,
    ) -> torch.Tensor:  # (T, 3, H, W) in [0, 1]
        ...


class ViewCrafterEngine:
    """The ViewCrafter stack behind DiffusionEngine. `params` live on the
    device the engine runs on, or, with a `mesh`, are split over its model
    axis (parallel/model_parallel.py::shard_params) with the requests, their
    guidance buffers and the activations on its home device (`device`;
    `devices` lists every device the engine uses); the prompt's text
    embeddings are computed once here (the prompt is fixed). `guided_cfg` configures the guided
    sampler; `w_recon`, `ssim_guidance`, `recon_loss` and `lpips_fn` the
    guidance loss (reference LossGuidance, viewcrafter_wrapper.py:47-99).
    `verbose` prints each request's settings. While `save_pred_x0_dir` is
    set, a guided request also writes each DDIM step's pred_x0 as a video
    there (reference LossGuidance.save_pred_x0, viewcrafter_wrapper.py:
    174-192), through `artifact_writer` when one is set."""

    def __init__(self, params: DiffusionParams, mcfg: LatentDiffusionConfig, scfg: SynthesisConfig,
                 guided_cfg: Optional[GuidedSampleConfig] = None, video_length: int = 25,
                 height: int = 320, width: int = 448, w_recon: float = 0.5,
                 ssim_guidance: bool = False, lpips_fn=None, recon_loss: str = "l2",
                 mesh: Optional[Mesh] = None):
        if mesh is not None:
            # the weights split over the mesh's model axis, read piece by
            # piece from `params` (JAX guided.py:340-343)
            params = shard_params(params, mesh)
            self.device, self.devices = mesh.home, tuple(dict.fromkeys(d for row in mesh.devices for d in row))
        else:
            self.device = params.unet["out.2.weight"].device
            self.devices = (self.device,)
        self.params, self.mcfg, self.scfg, self.mesh = params, mcfg, scfg, mesh
        self.guided_cfg = guided_cfg or GuidedSampleConfig()
        self.video_length, self.height, self.width = video_length, height, width
        self.w_recon, self.ssim_guidance, self.lpips_fn = w_recon, ssim_guidance, lpips_fn
        self.recon_loss = recon_loss
        # in the guidance-weight warmup mode the reference drops the alpha
        # mask and applies the loss everywhere (viewcrafter_wrapper.py:147-151)
        self.scale_weight_mode = False
        self.verbose = False
        self.save_pred_x0_dir: Optional[str] = None
        self.artifact_writer: Optional[AsyncArtifactWriter] = None
        with torch.no_grad(), device_scope(self.device):
            self.text_pair = encode_text_pair(params, scfg, self.device)

    def generate(self, pc_renders, guidance_images=None, guidance_masks=None, guidance_depths=None,
                 generator: Optional[torch.Generator] = None, no_guidance: bool = False,
                 scale_guidance_weight: float = 1.0,
                 noise: SynthesisNoise = SynthesisNoise()) -> torch.Tensor:
        """pc_renders: (T, H, W, 3) point-cloud renders in [0, 1] at any
        size (resized to the engine's, reference guided.py:557-565); the
        guidance images (T, 3, Hg, Wg) in [0, 1], masks and depths (T, 1,
        Hg, Wg) at any size (resized by resize_guidance). Returns the
        generated (T, 3, height, width) video in [0, 1] on the engine's
        device. `noise` injects the request's noise; the rest is drawn from
        `generator`."""
        with span("engine.generate"), device_scope(self.device):
            return self._generate(pc_renders, guidance_images, guidance_masks, guidance_depths, generator,
                                  no_guidance, scale_guidance_weight, noise)

    def _generate(self, pc_renders, guidance_images, guidance_masks, guidance_depths, generator,
                  no_guidance, scale_guidance_weight, noise) -> torch.Tensor:
        dev = self.device
        with torch.no_grad():
            video = resize_renders(pc_renders.to(dev, torch.float32), self.height, self.width)
        # a two-scale CFG request runs unguided, as the reference's multicond
        # sampler (JAX train/guided.py:582-584)
        guided = not no_guidance and not self.scfg.multiple_cond_cfg
        guidance_fn = None
        if guided:
            as_dev = (lambda a: None if a is None else a.to(dev, torch.float32))
            buffers = resize_guidance(as_dev(guidance_images), self.height, self.width,
                                      masks=None if self.scale_weight_mode else as_dev(guidance_masks),
                                      depths=as_dev(guidance_depths))
            guidance_fn = make_guidance_fn(buffers, w_recon=self.w_recon, ssim_guidance=self.ssim_guidance,
                                           lpips_fn=self.lpips_fn, recon_loss=self.recon_loss)
        if self.verbose:
            print(f"  [engine] {self.height}x{self.width}x{video.shape[0]} recon={self.recon_loss} "
                  f"w_recon={self.w_recon} ssim={self.ssim_guidance} lpips={self.lpips_fn is not None} "
                  f"guided={not no_guidance} sw={scale_guidance_weight}", flush=True)
        want_trace = bool(self.save_pred_x0_dir) and guided
        frames = image_guided_synthesis(self.params, self.mcfg, self.scfg, video * 2.0 - 1.0,
                                        generator=generator, noise=noise, guidance_fn=guidance_fn,
                                        guided_cfg=self.guided_cfg,
                                        scale_guidance_weight=scale_guidance_weight,
                                        text_pair=self.text_pair, pred_x0_trace=want_trace)
        if want_trace:
            frames, trace = frames
            self._save_pred_x0_videos(trace)
        return torch.clamp((frames + 1.0) / 2.0, 0.0, 1.0).permute(0, 3, 1, 2)

    def _save_pred_x0_videos(self, trace: torch.Tensor) -> None:
        """Decode the (S, T, h, w, 4) pred_x0 latents and write one video a
        DDIM step, named by the sampler's descending index as the reference
        (pred_x0_step<index>)."""
        s = trace.shape[0]
        for i in range(s):
            with torch.no_grad():
                frames = decode_video_frames(self.params, self.mcfg, trace[i])
            u8 = video_u8((frames + 1.0) / 2.0)
            path = os.path.join(self.save_pred_x0_dir, f"pred_x0_step{s - 1 - i:03d}.mp4")
            if self.artifact_writer is not None:
                self.artifact_writer.submit(save_video, u8, path)
            else:
                save_video(u8, path)


def _sync(device: torch.device) -> None:
    """Wait for the work queued before on the calling thread's stream of
    `device`, so a host clock reads it. Only that stream: a pipelined
    event's worker and the trainer each time their own work."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ----------------------------------------------------------------------------
# frozen renderer and the weightless engines
# ----------------------------------------------------------------------------


class FrozenRenderer:
    """Renders frozen Gaussian parameters for guidance, under no_grad, on
    the parameters' device (reference utils/easy_renderer.py:15-78); a
    trajectory in chains of GROUP frames (JAX FrozenRenderer._render_many,
    train/guided.py:102-135)."""

    GROUP = 5

    def __init__(self, params: G.GaussianParams, sh_degree: int, bg=None, backend: str = "auto"):
        self.params = params
        self.sh_degree = sh_degree
        self.device = params.xyz.device
        self.bg = torch.tensor(bg if bg is not None else [0.0, 0.0, 0.0], dtype=torch.float32,
                               device=self.device)
        self.backend = backend

    @torch.no_grad()
    def render(self, w2c: np.ndarray, K: np.ndarray, height: int, width: int):
        """(color (3, H, W), alpha (H, W), depth (H, W)) of an OpenCV w2c."""
        cam = camera_from_w2c_K(np.asarray(w2c), np.asarray(K), height, width)
        r = render_gaussians(self.params, cam.raster_camera(self.device), self.bg, self.sh_degree,
                             backend=self.backend)
        return r.color, r.alpha, r.depth

    @torch.no_grad()
    def render_many(self, w2cs: np.ndarray, K: np.ndarray, height: int, width: int):
        """The frames of a (T, 4, 4) trajectory: (color (T, 3, H, W),
        alpha (T, H, W), depth (T, H, W)); each group of GROUP frames (the
        last one shorter) one chain."""
        cams = [camera_from_w2c_K(np.asarray(w), np.asarray(K), height, width).raster_camera(self.device)
                for w in w2cs]
        groups = [render_gaussians_multi(self.params, cams[i:i + self.GROUP], self.bg, self.sh_degree,
                                         backend=self.backend)
                  for i in range(0, len(cams), self.GROUP)]
        return tuple(torch.cat(x) for x in zip(*((r.color, r.alpha, r.depth) for r in groups)))


class LiveRenderer(FrozenRenderer):
    """The training Gaussians as they are at each call (the reference's
    guidance_with_training_gs, train_guidedvd.py:493-517): `state` is the
    trainer's state itself, its parameters taken once a call (detached,
    under no_grad, so no training graph or gradient is held)."""

    def __init__(self, state: G.GaussianState, sh_degree: int, bg=None, backend: str = "auto"):
        super().__init__(state.params, sh_degree, bg, backend)
        self.state = state

    def _snapshot(self) -> None:
        self.params = SimpleNamespace(**self.state.params.tensors())  # the six, detached

    def render(self, w2c: np.ndarray, K: np.ndarray, height: int, width: int):
        self._snapshot()
        return super().render(w2c, K, height, width)

    def render_many(self, w2cs: np.ndarray, K: np.ndarray, height: int, width: int):
        self._snapshot()
        return super().render_many(w2cs, K, height, width)


class MockDiffusionEngine:
    """Weightless stand-in: the guidance renders where the mask says
    observed, the point-cloud render in the holes. Runs the guided trainer
    end to end without a diffusion model."""

    def __init__(self, video_length: int = 25, height: int = 320, width: int = 448):
        self.video_length, self.height, self.width = video_length, height, width

    @torch.no_grad()
    def generate(self, pc_renders, guidance_images, guidance_masks, guidance_depths,
                 generator: Optional[torch.Generator] = None, no_guidance: bool = False,
                 scale_guidance_weight: float = 1.0) -> torch.Tensor:
        pc = resize_renders(pc_renders, guidance_images.shape[2], guidance_images.shape[3])
        pc = pc.permute(0, 3, 1, 2)
        m = guidance_masks  # the observed mask
        return torch.clamp(guidance_images * m + pc * (1 - m), 0.0, 1.0)


class OracleDiffusionEngine:
    """Validation engine: the video is rendered from known ground-truth
    Gaussians (a `gt_gaussians.npz` of the synthetic scene), a perfect
    prior. The trainer hands it the event's trajectory by
    `set_trajectory`; `generate` renders it at the engine's size."""

    def __init__(self, gt_npz: str, video_length: int = 25, height: int = 320, width: int = 448,
                 sh_degree: int = 3, backend: str = "auto", device="cuda"):
        z = np.load(gt_npz)
        params = params_from_numpy({name: z[k] for k, name in GT_NPZ_KEYS.items()}, device)
        self.renderer = FrozenRenderer(params, sh_degree, backend=backend)
        self.video_length, self.height, self.width = video_length, height, width
        self._w2cs = None
        self._K = None

    def set_trajectory(self, w2cs: np.ndarray, K: np.ndarray) -> None:
        self._w2cs, self._K = np.asarray(w2cs), np.asarray(K)

    def generate(self, pc_renders, guidance_images, guidance_masks, guidance_depths,
                 generator: Optional[torch.Generator] = None, no_guidance: bool = False,
                 scale_guidance_weight: float = 1.0) -> torch.Tensor:
        if self._w2cs is None:
            raise RuntimeError("OracleDiffusionEngine: set_trajectory was not called")
        rgb, _, _ = self.renderer.render_many(self._w2cs, self._K, self.height, self.width)
        return torch.clamp(rgb, 0.0, 1.0)


# ----------------------------------------------------------------------------
# trajectory pool
# ----------------------------------------------------------------------------


@dataclass
class TrajEntry:
    cand_idx: int
    traj_c2ws: np.ndarray  # (T, 4, 4) world frame
    center_scale: float
    scale_idx: int
    obj_c2w: np.ndarray  # (1, 4, 4) the source pose in the object frame
    transform_back: np.ndarray  # (4, 4)


@dataclass
class EventInputs:
    """What an event's device work needs, fixed by its host prelude."""

    iteration: int
    view: int
    traj: np.ndarray  # (T, 4, 4) c2w
    w2cs: np.ndarray  # (T, 4, 4)
    event_dir: str
    sw: float  # the guidance-weight schedule's factor
    video_key: Optional[tuple]
    stored: Optional[str]  # the stored video read instead of a request
    train_image: torch.Tensor  # (3, H, W): the trajectory's frame 0
    live: Optional["FrozenRenderer"]  # the training Gaussians' renderer, or None


@dataclass
class EventRecord:
    """An event's outputs, as finalize takes them."""

    view: int
    traj: np.ndarray
    video: torch.Tensor  # (T, 3, H, W) float32 in [0, 1] on the trainer's device
    gs_alpha: torch.Tensor  # (T, 1, H, W), 1 where unobserved
    gs_depth: torch.Tensor  # (T, 1, H, W)
    event_dir: str
    video_key: Optional[tuple]
    phase_s: Dict[str, float] = field(default_factory=dict)


@dataclass
class PendingEvent:
    """A submitted event: its record, or the worker's future of (record,
    the CUDA event its stream recorded at the end)."""

    record: Optional[EventRecord] = None
    future: Optional[Future] = None


def select_topk_candidates(areas: np.ndarray, mask_thresh: float, top_k: int) -> np.ndarray:
    """The candidates whose unobserved area is below the threshold, the
    top_k largest areas of them in descending order, ties in index order
    (reference train_guidedvd.py:175-179)."""
    ok = np.nonzero(areas < mask_thresh)[0]
    order = np.argsort(-areas[ok], kind="stable")[:top_k]
    return ok[order]


def build_trajectory_pool(
    frozen: FrozenRenderer,
    train_c2ws: np.ndarray,  # (V, 4, 4)
    intrinsic: np.ndarray,  # (3, 3)
    center_depths: np.ndarray,  # (V,) depth at each view's centre pixel
    height: int,
    width: int,
    center_scale: float = 1.0,
    elevation: float = 5.0,
    video_length: int = 25,
) -> Dict[int, List[TrajEntry]]:
    """Eq. 7's pool: per view, 3 radius scales x (5 phi x 4 or 5 theta)
    candidates, keeping the (3, 2, 1) best of each scale."""
    d_phi = [-30, -15, 0, 15, 30]
    d_theta = [-30, -15, 0, 15, 30] if center_scale != 1 else [-15, -7.5, 0, 7.5]
    mask_thresh = 0.1 * height * width
    scales = [(center_scale, 3, 1), (center_scale / 3.0, 2, 2), (center_scale / 10.0, 1, 3)]
    pool: Dict[int, List[TrajEntry]] = {}
    for v in range(train_c2ws.shape[0]):
        pool[v] = []
        for cs, top_k, scale_idx in scales:
            radius = float(center_depths[v]) * cs
            obj_poses, back = pm.world_to_obj(train_c2ws[v][None], -1, radius, elevation)
            cands, offsets = pm.candidate_pose_grid(obj_poses, back, d_phi, d_theta)
            w2cs = np.stack([np.linalg.inv(c) for c in cands])
            _, alphas, _ = frozen.render_many(w2cs, intrinsic, height, width)
            areas = morph.erode((alphas < 0.7).to(torch.float32), 5).sum(dim=(1, 2)).cpu().numpy()
            for j in select_topk_candidates(areas, mask_thresh, top_k):
                ph, th, dr = offsets[j]
                traj = back[None] @ pm.interpolate_trajectory(obj_poses, ph, th, dr, frames=video_length)
                pool[v].append(TrajEntry(int(j), traj, cs, scale_idx, obj_poses, back))
    return pool


# ----------------------------------------------------------------------------
# the guided step
# ----------------------------------------------------------------------------


def train_step_guided(
    state: G.GaussianState,
    cam: RasterCamera,
    gt_image: torch.Tensor,
    pseudo_cam: Optional[RasterCamera],
    pseudo_gt: Optional[torch.Tensor],
    pseudo_weight: float,
    bg: torch.Tensor,
    lrs: G.LearningRates,
    sh_degree: int,
    lambda_dssim: float,
    use_confidence: bool = False,
    backend: str = "auto",
    pseudo_ssim: bool = False,
    apply_adam: bool = True,
    update_stats: bool = True,
    vgg_loss_fn: Optional[Callable] = None,
    pseudo_cam_lpips_weight: float = 0.1,
) -> dict:
    """One step on the train view and, when `pseudo_cam` is given, a pseudo
    view, updating `state` in place (reference train_guidedvd.py:330-416):
    loss = (1 - l) L1 + l (1 - SSIM) of the train view + pseudo_weight *
    the pseudo view's L1 (its (1 - l) L1 + l (1 - SSIM) with pseudo_ssim),
    plus pseudo_cam_lpips_weight times the perceptual `vgg_loss_fn` of the
    clamped render and pseudo ground truth when given (:368-371). The
    views are one chain (models/render.py::render_gaussians_multi, as the
    JAX package's train_scan body renders them, its train/guided.py:
    897-916), each with its own zero screen offset for the densification
    statistics; one backward pass. Returns the metrics (loss, l1, pseudo_l1,
    pseudo_vgg, psnr as device tensors; num_instances, the chain's)."""
    dev = state.device
    cams = [cam] if pseudo_cam is None else [cam, pseudo_cam]
    with span("train.render"):
        offsets = torch.zeros((len(cams), state.num_gaussians, 2), device=dev, requires_grad=True)
        rm = render_gaussians_multi(state.params, cams, bg, sh_degree, means2d_offset=offsets,
                                    confidence=state.confidence, use_confidence=use_confidence, backend=backend)
        # the views' fields: one UnbindBackward node stacks their gradients
        r, *rest = (RenderResult(*fields, rm.num_instances) for fields in zip(*(x.unbind(0) for x in rm[:5])))
    rp = rest[0] if rest else None
    with span("train.loss"):
        pl1, pvgg = torch.zeros((), device=dev), torch.zeros((), device=dev)
        ll1 = l1_loss(r.color, gt_image)
        loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(r.color, gt_image))
        if rp is not None:
            pl1 = l1_loss(rp.color, pseudo_gt)
            if pseudo_ssim:
                ploss = (1.0 - lambda_dssim) * pl1 + lambda_dssim * (1.0 - ssim(rp.color, pseudo_gt))
            else:
                ploss = pl1
            if vgg_loss_fn is not None:
                x, y = torch.clamp(rp.color, 0, 1)[None], torch.clamp(pseudo_gt, 0, 1)[None]
                with span("train.vgg"):
                    pvgg = vgg_loss_fn(x, y)
                ploss = ploss + pseudo_cam_lpips_weight * pvgg
            loss = loss + pseudo_weight * ploss
    state.params.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    if update_stats:
        with span("train.stats"):
            G.update_max_radii(state, r.radii, r.visibility_filter)
            if rp is not None:
                G.update_max_radii(state, rp.radii, rp.visibility_filter)
                G.add_densification_stats_with_novel_pose(state, offsets.grad[0], r.visibility_filter,
                                                          offsets.grad[1], rp.visibility_filter)
            else:
                G.add_densification_stats(state, offsets.grad[0], r.visibility_filter)
    if apply_adam:
        with span("train.adam"):
            G.adam_step(state, {n: getattr(state.params, n).grad for n in G.PARAM_NAMES}, lrs)
    with torch.no_grad():
        return {"loss": loss.detach(), "l1": ll1.detach(), "pseudo_l1": pl1.detach(),
                "pseudo_vgg": pvgg.detach(), "psnr": psnr(r.color, gt_image)[0, 0],
                "num_instances": r.num_instances}


# ----------------------------------------------------------------------------
# trainer
# ----------------------------------------------------------------------------


class GuidedTrainer(BaselineTrainer):
    """train_guidedvd.py:48-636 around `train_step_guided`, per step.

    Host draws follow the reference's streams in its order: the train
    views from `random.Random(seed)` (BaselineTrainer), the pool
    shuffles, event views, pseudo views and promotions from
    `np.random.default_rng(seed)`. A checkpoint holds the whole guided
    state (train/guided_checkpoint.py), so a run resumed from it is
    bitwise the run that wrote it. `vgg_loss_fn` adds the
    perceptual pseudo term; `frozen_mask`, a second frozen renderer, picks
    the pool's candidates and supplies each event's mask (the two-renderer
    variant, reference train_replica_guidedvd_tworenderer.py:60-74).
    `depth_estimator` (frames (T, H, W, 3) in [-1, 1] -> (T, H, W) relative
    inverse depth, guidance/dpt.py::make_depth_estimator) lifts each event's
    video to new Gaussians when the options ask for
    append_pcd_from_video_diffusion; `points_added` counts them.

    `pipeline_guidance` lags each event one boundary (the JAX package's
    pipelined events): at a boundary the pending event is finalized, then
    the new one submitted; `train` finalizes the last one before the
    artifact writes drain and `write_checkpoint` before it writes. Its
    device work runs on a worker thread with its own CUDA stream, or, with
    `event_worker` False, at once on this thread (the same lagged order;
    the two give the same bits). `event_wait_s` counts the seconds a
    finalize waited for the worker. The engine's torch `Generator` is used
    only by the device work. The steps stay on the caller's stream at its
    priority: a stream of higher priority for them showed no consistent
    gain on one card (chip_smoke.py phase 10 measures both)."""

    def __init__(self, scene, state: G.GaussianState, opt, pipe, model_params,
                 frozen: FrozenRenderer, engine: DiffusionEngine, pcd_points: np.ndarray,
                 pcd_colors: np.ndarray, guidance_intrinsic: np.ndarray, background=None,
                 seed: int = 1, elevation: float = 5.0, hybrid_traj: bool = False,
                 vgg_loss_fn: Optional[Callable] = None, frozen_mask: Optional[FrozenRenderer] = None,
                 depth_estimator: Optional[Callable] = None, pipeline_guidance: bool = False,
                 event_worker: bool = True):
        super().__init__(scene, state, opt, pipe, model_params, background)
        self.frozen = frozen
        self.frozen_mask = frozen_mask
        self.engine = engine
        self.vgg_loss_fn = vgg_loss_fn
        self.depth_estimator = depth_estimator
        self.points_added = 0
        self.pcd_points = torch.from_numpy(np.ascontiguousarray(pcd_points, np.float32)).to(self.device)
        self.pcd_colors = torch.from_numpy(np.ascontiguousarray(pcd_colors, np.float32)).to(self.device)
        self.intrinsic = np.asarray(guidance_intrinsic)
        self.elevation = elevation
        self.rng_np = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.train_cams = list(scene.getTrainCameras())
        self.H = self.train_cams[0].image_height
        self.W = self.train_cams[0].image_width
        # guided runs hold the SH degree at its maximum (reference :327-329)
        self.active_sh_degree = self.max_sh_degree
        self.pseudo_stack: List[PseudoCamera] = []
        self.pseudo_stack_alltime: List[PseudoCamera] = []
        self.trajectory_pool: Dict[int, List[TrajEntry]] = {}
        self.trajectory_pool_shuffle: Dict[int, List[TrajEntry]] = {}
        self.vd_indices: List[int] = []
        self.events_run = 0
        # the hybrid-traj variant: the first epoch of events takes the loop2
        # preset, then the pool (train_scannetpp_guidedvd_hybrid_traj.py:318)
        self.hybrid_traj = hybrid_traj
        self.txt_traj_warmup = hybrid_traj
        self.event_phase_s = {"pc_render": 0.0, "frozen": 0.0, "artifacts": 0.0, "generate": 0.0,
                              "lift": 0.0}
        self._visible = {}  # source view -> (N,) bool of the points it sees
        self._live_renderer: Optional[LiveRenderer] = None
        self._cur_video_key = None  # (scale_idx, view, cand_idx) of the event's pool entry
        self.artifact_writer = AsyncArtifactWriter()
        self.last_metrics = None
        self.pipeline_guidance = pipeline_guidance
        self.event_worker = event_worker
        self.event_wait_s = 0.0
        self._pending_event: Optional[PendingEvent] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._streams: Optional[List[torch.cuda.Stream]] = None

    def write_checkpoint(self, path: str, iteration: int) -> None:
        """The guided checkpoint; an event in flight is finalized first, so
        the checkpoint holds its stacks (a checkpointed run's stream then
        parts from the same run without checkpoints; its resume is bitwise
        the run that wrote it, as in the JAX package, guided.py:1724-1733)."""
        from guidedvd3dgs_tpu_torch.train.guided_checkpoint import save_guided_checkpoint

        self.flush_pending_event()
        save_guided_checkpoint(path, self, iteration)
        print(f"[ITER {iteration}] saved guided checkpoint {path} (+ .guided.npz)")

    # -- setup ---------------------------------------------------------------

    def init_view_geometry(self) -> None:
        """Each train view's c2w and the frozen model's depth at its centre
        pixel."""
        c2ws, depths = [], []
        for cam in self.train_cams:
            w2c = np.asarray(cam.world_view_transform).T  # stored transposed
            c2ws.append(np.linalg.inv(w2c))
            _, _, depth = self.frozen.render(w2c, self.intrinsic, self.H, self.W)
            depths.append(float(depth[self.H // 2, self.W // 2]))
        self.train_c2ws = np.stack(c2ws)
        self.center_depths = np.asarray(depths)

    def init_trajectory_pool(self) -> None:
        self.init_view_geometry()
        self.trajectory_pool = build_trajectory_pool(
            self.frozen_mask or self.frozen, self.train_c2ws, self.intrinsic, self.center_depths,
            self.H, self.W,
            center_scale=self.opt.guidance_vc_center_scale, elevation=self.elevation,
            video_length=self.engine.video_length,
        )
        self.trajectory_pool_shuffle = {k: self._shuffled(v) for k, v in self.trajectory_pool.items()}

    def _shuffled(self, entries):
        out = list(entries)
        self.rng_np.shuffle(out)
        return out

    def _next_view(self) -> int:
        if not self.vd_indices:
            idx = np.arange(len(self.train_cams))
            self.rng_np.shuffle(idx)
            self.vd_indices = idx.tolist()
            if self.events_run > 0:
                self.txt_traj_warmup = False  # the warm-up covers one epoch of views
        return self.vd_indices.pop()

    def _txt_trajectory(self, view: int, preset: str = "loop2") -> np.ndarray:
        """A preset trajectory anchored at the view (reference
        viewcrafter_wrapper.py:469-548, the txt path)."""
        radius = float(self.center_depths[view]) * self.opt.guidance_vc_center_scale
        obj_poses, back = pm.world_to_obj(self.train_c2ws[view][None], -1, radius, self.elevation)
        phis, thetas, rs = pm.TRAJ_PRESETS[preset]
        return back[None] @ pm.traj_from_txt(obj_poses, phis, thetas, rs, frames=self.engine.video_length)

    # -- diffusion event -------------------------------------------------------

    def pc_render_along(self, traj_c2ws: np.ndarray, view_idx: int,
                        train_image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(T, H, W, 3): the point cloud splatted along the trajectory, frame
        0 replaced by the real train image (reference viewcrafter_wrapper.py:
        469-548; `train_image`, (3, H, W) on the device, where the caller
        has it). By default only the points seen from the source view are
        splatted (the reference's pc_render_single_view); the mask is
        computed once per view."""
        w2cs = torch.from_numpy(np.stack([np.linalg.inv(c) for c in traj_c2ws]).astype(np.float32))
        w2cs = w2cs.to(self.device)
        K = torch.from_numpy(np.asarray(self.intrinsic, np.float32))
        visible = None
        if not getattr(self.opt, "guidance_pc_render_all_views", False):
            visible = self._visible.get(view_idx)
            if visible is None:
                visible = self._visible[view_idx] = visible_points_mask(
                    self.pcd_points, w2cs[0], K, self.H, self.W)
        with torch.no_grad():
            frames = torch.stack([
                splat_points_world(self.pcd_points, self.pcd_colors, w2c, K, self.H, self.W,
                                   point_mask=visible).image
                for w2c in w2cs
            ])
        if train_image is None:
            train_image = self.camera_on_device(self.train_cams[view_idx])[1]
        frames[0] = train_image.permute(1, 2, 0)
        return frames

    def run_diffusion_event(self, iteration: int) -> None:
        """One event, synchronously (reference train_guidedvd.py:431-636)."""
        pending = self.submit_diffusion_event(iteration)
        if pending is not None:
            self.finalize_diffusion_event(pending)

    def _event_dir(self, iteration: int) -> str:
        """The event's artifact directory (reference LossGuidance.
        update_save_dir, viewcrafter_wrapper.py:167-171); "" when there is
        no model path or `save_event_artifacts` is off."""
        mp = getattr(self.model_params, "model_path", "") or ""
        if not mp or not getattr(self.opt, "save_event_artifacts", True):
            return ""
        d = os.path.join(mp, "diffusion_events", f"train_iter{iteration}")
        os.makedirs(d, exist_ok=True)
        return d

    def _video_file_path(self, key="cur") -> Optional[str]:
        """The stored video of a pool entry (scale_idx, view, cand_idx):
        `<model>/video_files_scale{s}/{view}/{cand}.npz` (the reference's
        video_files_scale layout, train_guidedvd.py:562-566, and the JAX
        package's npz), or None."""
        if key == "cur":
            key = self._cur_video_key
        mp = getattr(self.model_params, "model_path", "") or ""
        if key is None or not mp:
            return None
        s, v, c = key
        return os.path.join(mp, f"video_files_scale{s}", str(v), f"{c}.npz")

    def _guidance_renderer(self, iteration: int) -> Optional[FrozenRenderer]:
        """The renderer of the training Gaussians from
        guidance_with_training_gs_startiter on with guidance_with_training_gs
        (reference :493-524), else None (the frozen baseline's renders).
        With pipeline_guidance it renders a copy of them taken now: the
        trainer changes them in place (Adam, densification) while the
        event's worker renders."""
        opt = self.opt
        if not (getattr(opt, "guidance_with_training_gs", False)
                and iteration >= getattr(opt, "guidance_with_training_gs_startiter", 0)):
            return None
        if self._live_renderer is None:
            self._live_renderer = LiveRenderer(self.state, self.max_sh_degree, backend=self.frozen.backend)
        self._live_renderer.state = self.state
        if not self.pipeline_guidance:
            return self._live_renderer
        snapshot = {k: v.clone() for k, v in self.state.params.tensors().items()}
        return FrozenRenderer(SimpleNamespace(**snapshot), self.max_sh_degree, backend=self.frozen.backend)

    def _guidance_renders(self, w2cs: np.ndarray, live: Optional[FrozenRenderer]):
        """(rgb, alpha, depth) of the event's frames: the frozen baseline's;
        the alpha of `frozen_mask` where there is one; with `live` (see
        `_guidance_renderer`), rgb and depth of the training Gaussians, and
        their alpha too with guidance_with_training_gs_decide_mask."""
        args = (w2cs, self.intrinsic, self.H, self.W)
        if live is not None:
            rgb, alpha, depth = live.render_many(*args)
            if not getattr(self.opt, "guidance_with_training_gs_decide_mask", False):
                _, alpha, _ = (self.frozen_mask or self.frozen).render_many(*args)
        else:
            rgb, alpha, depth = self.frozen.render_many(*args)
            if self.frozen_mask is not None:
                _, alpha, _ = self.frozen_mask.render_many(*args)
        return rgb, alpha, depth

    def _save_event_artifacts(self, event_dir: str, pc_renders, gs_rgb, gs_alpha, gs_depth) -> None:
        """The event's input videos (reference train_guidedvd.py:531-542):
        the point-cloud renders, the guidance renders, the unobserved mask
        and the observed depth normalised to [0, 1]; quantised on the
        device, encoded by the background writer."""
        d = gs_depth[:, 0] * (1.0 - gs_alpha[:, 0])
        dn = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-8)
        for name, frames in (("render0", pc_renders), ("gs_render", gs_rgb),
                             ("gs_render_alpha", gs_alpha[:, 0]), ("gs_render_depth", dn)):
            self.artifact_writer.submit(save_video, video_u8(frames), os.path.join(event_dir, f"{name}.mp4"))

    def _event_trajectory(self, view: int) -> Optional[np.ndarray]:
        opt = self.opt
        if self.txt_traj_warmup:
            return self._txt_trajectory(view)
        if not getattr(opt, "use_trajectory_pool", True):
            # the txt-preset mode (reference train_guidedvd.py:434-452)
            preset = "loop2"
            if getattr(opt, "guidance_random_traj", False):
                r = self.rng_np.random()
                if getattr(opt, "guidance_no_wave_traj", False):
                    preset = "loop2" if r < 0.5 else "loop1"
                else:
                    preset = "loop2" if r < 0.33 else ("loop1" if r < 0.66 else "wave1")
            return self._txt_trajectory(view, preset)
        if not self.trajectory_pool_shuffle.get(view):
            self.trajectory_pool_shuffle[view] = self._shuffled(self.trajectory_pool[view])
        if not self.trajectory_pool_shuffle[view]:
            return None  # no valid trajectory for this view
        entry = self.trajectory_pool_shuffle[view].pop()
        self._cur_video_key = (entry.scale_idx, view, entry.cand_idx)
        return entry.traj_c2ws

    def submit_diffusion_event(self, iteration: int) -> Optional["PendingEvent"]:
        """Start one event (reference train_guidedvd.py:431-559): the host
        prelude here (`_event_prelude`), then its device work
        (`_event_device_work`): at once, or, with pipeline_guidance and
        `event_worker`, on the worker thread and its own CUDA stream, this
        returning at once. Returns what `finalize_diffusion_event` takes, or
        None when the view has no trajectory."""
        inputs = self._event_prelude(iteration)
        if inputs is None:
            return None
        if not (self.pipeline_guidance and self.event_worker):
            return PendingEvent(record=self._event_device_work(inputs))
        ready = None
        if self.device.type == "cuda":
            streams = self._worker_streams()
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            if inputs.live is not None:  # the snapshot, made on this stream, read on the worker's
                for t in vars(inputs.live.params).values():
                    t.record_stream(streams[-1])
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="guided-event")
        return PendingEvent(future=self._executor.submit(self._worker_event, inputs, ready))

    def _event_prelude(self, iteration: int) -> Optional["EventInputs"]:
        """The event's host work, on the trainer's thread in the reference's
        order: the view, the trajectory (every draw of `rng_np` and pool
        pop), the store key, the engine's trajectory, the guidance-weight
        schedule, the artifact directory and the stored video's path."""
        opt = self.opt
        view = self._next_view()
        self._cur_video_key = None
        traj = self._event_trajectory(view)
        if traj is None:
            return None
        w2cs = np.stack([np.linalg.inv(traj[i]) for i in range(traj.shape[0])])
        event_dir = self._event_dir(iteration)
        sw = guidance_weight_schedule(iteration) if getattr(opt, "scale_guidance_weight", False) else 1.0
        if hasattr(self.engine, "set_trajectory"):
            self.engine.set_trajectory(w2cs, self.intrinsic)
        if hasattr(self.engine, "save_pred_x0_dir"):
            # the per-DDIM-step pred_x0 videos into the event's directory
            self.engine.save_pred_x0_dir = event_dir if event_dir and getattr(opt, "save_pred_x0", False) \
                else None
            self.engine.artifact_writer = self.artifact_writer
        vf = self._video_file_path() if getattr(opt, "guidance_videos_from_file", False) else None
        return EventInputs(
            iteration=iteration, view=view, traj=traj, w2cs=w2cs, event_dir=event_dir, sw=sw,
            video_key=self._cur_video_key, stored=vf if vf is not None and os.path.exists(vf) else None,
            train_image=self.camera_on_device(self.train_cams[view])[1],
            live=self._guidance_renderer(iteration))

    def _event_device_work(self, inp: "EventInputs") -> "EventRecord":
        """Render the event's inputs, write its artifacts and generate its
        video, or read it from the store with guidance_videos_from_file
        (reference train_guidedvd.py:431-559). Each phase's seconds (its
        device work included) go into the record."""
        opt, iteration = self.opt, inp.iteration
        phase = {}
        _sync(self.device)
        with span("event.pc_render", into=phase, key="pc_render"):
            pc_renders = self.pc_render_along(inp.traj, inp.view, inp.train_image)
            _sync(self.device)

        with span("event.frozen", into=phase, key="frozen"):
            rgb, alpha, depth = self._guidance_renders(inp.w2cs, inp.live)
            gs_rgb = torch.clamp(rgb, 0, 1)  # (T, 3, H, W)
            gs_alpha = (torch.clamp(alpha, 0, 1) < 0.9).to(torch.float32)[:, None]  # unobserved
            gs_depth = depth[:, None]
            _sync(self.device)

        with span("event.artifacts", into=phase, key="artifacts"):
            if inp.event_dir:
                self._save_event_artifacts(inp.event_dir, pc_renders, gs_rgb, gs_alpha, gs_depth)

        with span("event.generate", into=phase, key="generate"):
            if inp.stored is not None:
                # a stored video instead of a request (reference --guidance_videos_from_file)
                video = torch.from_numpy(np.load(inp.stored)["video"]).to(self.device)
                print(f"  [event it{iteration}] video from file {inp.stored}", flush=True)
            else:
                video = self.engine.generate(pc_renders, gs_rgb, 1.0 - gs_alpha, gs_depth,
                                             generator=self.generator,
                                             no_guidance=getattr(opt, "no_guidance", False),
                                             scale_guidance_weight=inp.sw)  # (T, 3, h, w) in [0, 1]
                # the engine may run on another card and in bf16: the pseudo
                # ground truth is float32 on the trainer's
                video = video.to(self.device, torch.float32)
                if video.shape[2:] != (self.H, self.W):
                    # back to the train resolution (reference train_guidedvd.py:557-559)
                    video = resize_renders(video.permute(0, 2, 3, 1), self.H, self.W).permute(0, 3, 1, 2)
            _sync(self.device)
        print(f"  [event it{iteration}] pc_render {phase['pc_render']:.3f}s frozen x{inp.traj.shape[0]} "
              f"{phase['frozen']:.3f}s artifacts {phase['artifacts']:.3f}s generate {phase['generate']:.3f}s",
              flush=True)
        return EventRecord(inp.view, inp.traj, video, gs_alpha, gs_depth, inp.event_dir, inp.video_key, phase)

    def _worker_streams(self) -> List[torch.cuda.Stream]:
        """The worker's CUDA streams, made once: one on each card of the
        engine (every device of its mesh) that is not the trainer's, then
        one on the trainer's (the last entered, so that it is the worker's
        current device). PyTorch orders a copy between two cards on both
        cards' current streams, which in the worker are these."""
        if self._streams is None:
            eng = getattr(self.engine, "devices", (getattr(self.engine, "device", self.device),))
            devs = [d for d in dict.fromkeys(torch.device(e) for e in eng) if d != self.device]
            self._streams = [torch.cuda.Stream(device=d) for d in devs + [self.device]]
        return self._streams

    def _worker_event(self, inp: "EventInputs", ready: Optional[torch.cuda.Event]):
        """On the worker thread: the event's device work on the worker's
        streams once they have waited for the trainer's work up to the
        submission (`ready`). Returns the record and the CUDA event its
        stream records at the end (None on the CPU)."""
        if ready is None:
            return self._event_device_work(inp), None
        streams = self._worker_streams()
        with contextlib.ExitStack() as stack:
            for st in streams:
                stack.enter_context(torch.cuda.stream(st))
                st.wait_event(ready)
            record = self._event_device_work(inp)
            done = torch.cuda.Event()
            done.record(streams[-1])
        return record, done

    def _join_event(self, pending: "PendingEvent") -> "EventRecord":
        """The record of a submitted event; a worker's is waited for (the
        seconds add to `event_wait_s`) and the trainer's stream made to wait
        for the worker's, its tensors marked as used on it."""
        if pending.future is None:
            return pending.record
        waited = {}
        with span("event.wait", into=waited):
            record, done = pending.future.result()
        self.event_wait_s += waited["event.wait"]
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for x in (record.video, record.gs_alpha, record.gs_depth):
                x.record_stream(cur)
        return record

    def finalize_diffusion_event(self, pending: "PendingEvent") -> None:
        """Write the event's video (diffusion0 with the artifacts; the store
        with guidance_save_videos, synchronously, so that a later event of
        this run may read it), lift its unobserved pixels to new Gaussians
        with append_pcd_from_video_diffusion and a depth estimator, and
        rebuild the pseudo stacks from it: every frame but the first, a
        fifth of them also to the all-time stack (reference
        train_guidedvd.py:557-636)."""
        rec = self._join_event(pending)
        for k, v in rec.phase_s.items():
            self.event_phase_s[k] += v
        view, traj, video, gs_alpha, event_dir = rec.view, rec.traj, rec.video, rec.gs_alpha, rec.event_dir
        if event_dir:
            self.artifact_writer.submit(save_video, video_u8(video), os.path.join(event_dir, "diffusion0.mp4"))
        if getattr(self.opt, "guidance_save_videos", False):
            vf = self._video_file_path(rec.video_key)
            if vf is None and event_dir:
                vf = os.path.join(event_dir, f"video_view{view}.npz")  # no pool entry (txt mode)
            if vf:
                os.makedirs(os.path.dirname(vf), exist_ok=True)
                np.savez_compressed(vf, video=video.cpu().numpy())
        if getattr(self.opt, "append_pcd_from_video_diffusion", False) and self.depth_estimator is not None:
            self.append_lifted_points(video, gs_alpha, rec.gs_depth, traj)
        fovx, fovy = self.train_cams[view].FoVx, self.train_cams[view].FoVy
        self.pseudo_stack = []
        for i in range(1, traj.shape[0]):  # frame 0 is the conditioning image
            w2c = np.linalg.inv(traj[i])
            cam = PseudoCamera(R=w2c[:3, :3].T, T=w2c[:3, 3], FoVx=fovx, FoVy=fovy, width=self.W,
                               height=self.H, pseudo_gt=video[i], mask=gs_alpha[i])
            self.pseudo_stack.append(cam)
            if self.rng_np.random() > 0.8:
                # the all-time stack outlives the event: own copies of the
                # frame, so the whole video is not kept for it
                alt = copy.copy(cam)
                alt.pseudo_gt, alt.mask = video[i].clone(), gs_alpha[i].clone()
                self.pseudo_stack_alltime.append(alt)
        self.events_run += 1

    def flush_pending_event(self) -> None:
        """Finalize the event in flight, if one is (pipeline_guidance)."""
        if self._pending_event is not None:
            pending, self._pending_event = self._pending_event, None
            self.finalize_diffusion_event(pending)

    def close_event_worker(self) -> None:
        """Finalize the event in flight and stop the worker thread."""
        self.flush_pending_event()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def append_lifted_points(self, video: torch.Tensor, gs_alpha: torch.Tensor, gs_depth: torch.Tensor,
                             traj: np.ndarray) -> int:
        """The event's frames (T, 3, H, W) lifted where the frozen render
        leaves them unobserved (`gs_alpha` (T, 1, H, W) 1 there), their
        relative depth fitted to the frozen render's depth `gs_depth` where
        observed, and appended as Gaussians (reference train_guidedvd.py:
        569-612). Returns the number of points added; the seconds add to
        event_phase_s["lift"]."""
        _sync(self.device)
        with span("event.lift", into=self.event_phase_s, key="lift"):
            frames = video.permute(0, 2, 3, 1)
            rel = self.depth_estimator(frames * 2.0 - 1.0)
            pts, rgbs = lift_video_to_points(frames.cpu().numpy(), rel.cpu().numpy(),
                                             gs_depth[:, 0].cpu().numpy(), 1.0 - gs_alpha[:, 0].cpu().numpy(),
                                             traj, self.intrinsic)
            if pts.shape[0]:
                G.add_points(self.state, pts, rgbs)
            self.points_added += pts.shape[0]
            _sync(self.device)
        return pts.shape[0]

    # -- per-iteration step ----------------------------------------------------

    def _pick_pseudo(self, iteration: int) -> Optional[PseudoCamera]:
        opt = self.opt
        if iteration % opt.sample_pseudo_interval != 0:
            return None
        if not (opt.start_sample_pseudo < iteration < opt.end_sample_pseudo):
            return None
        if not self.pseudo_stack and not self.pseudo_stack_alltime:
            return None
        if self.rng_np.random() > 0.5 and self.pseudo_stack_alltime:
            stack = self.pseudo_stack_alltime
        else:
            stack = self.pseudo_stack or self.pseudo_stack_alltime
        return stack[self.rng_np.integers(0, len(stack))]

    def _pseudo_weight(self, iteration: int) -> float:
        opt = self.opt
        w = opt.pseudo_cam_weight
        if getattr(opt, "pseudo_cam_weight_decay", False):
            interval = max(opt.guidance_vd_iter, 1)
            frac = np.clip((iteration % interval) / interval, 0, 1)
            w = opt.pseudo_cam_weight_start * (1 - frac) + frac * opt.pseudo_cam_weight_end
        return float(w)

    def _step(self, iteration: int) -> StepStats:
        opt = self.opt
        rc, gt = self.camera_on_device(self.pick_camera())
        pseudo = self._pick_pseudo(iteration)
        do_densify = (
            iteration < opt.densify_until_iter
            and iteration > opt.densify_from_iter
            and iteration % opt.densification_interval == 0
        )
        metrics = train_step_guided(
            self.state, rc, gt,
            None if pseudo is None else pseudo.raster_camera(self.device),
            None if pseudo is None else pseudo.pseudo_gt,
            0.0 if pseudo is None else self._pseudo_weight(iteration),
            self.bg, lrs_for(opt, self.xyz_lr), self.active_sh_degree, opt.lambda_dssim,
            use_confidence=getattr(self.pipe, "use_confidence", False), backend=self.backend,
            pseudo_ssim=getattr(opt, "pseudo_cam_ssim", False),
            apply_adam=(iteration < opt.iterations) and not do_densify,
            update_stats=iteration < opt.densify_until_iter,
            vgg_loss_fn=self.vgg_loss_fn,
            pseudo_cam_lpips_weight=getattr(opt, "pseudo_cam_lpips_weight", 0.1),
        )
        if do_densify:
            self.densify(iteration)
        self.xyz_lr = self.xyz_sched(iteration)
        if iteration % opt.opacity_reset_interval == 0:
            G.reset_opacity(self.state)
        # a diffusion event after the step (reference :431)
        if (iteration - 1) % opt.guidance_vd_iter == 0 and iteration < opt.end_sample_pseudo:
            if self.pipeline_guidance:
                self.flush_pending_event()
                self._pending_event = self.submit_diffusion_event(iteration)
            else:
                self.run_diffusion_event(iteration)
        self.ema_loss = 0.4 * metrics["loss"] + 0.6 * self.ema_loss
        self.last_metrics = metrics
        return StepStats(loss=metrics["loss"], l1=metrics["l1"], psnr=metrics["psnr"],
                         num_active=self.state.num_gaussians, num_instances=metrics["num_instances"])

    def log_scalars(self, stats: StepStats) -> dict:
        """BaselineTrainer's scalars and the last step's pseudo_l1 (as the
        JAX package's train_scan logs it; 0 without a pseudo view)."""
        return {**super().log_scalars(stats), "pseudo_l1": float(self.last_metrics["pseudo_l1"])}

    def train(self, iterations=None, start_iteration=0, **kwargs):
        """BaselineTrainer.train, then the event in flight finalized and the
        worker stopped, the artifact writes drained (a failed write raises
        here) and `<model>/timing_summary.json`: the run's seconds split
        into events (by phase) and training."""
        t0 = time.perf_counter()
        try:
            out = super().train(iterations, start_iteration=start_iteration, **kwargs)
            self.close_event_worker()
        finally:
            if self._executor is not None:  # a step raised: stop the worker all the same
                self._executor.shutdown(wait=True)
                self._executor = None
        self.artifact_writer.drain()
        _sync(self.device)
        total_s = time.perf_counter() - t0
        self.write_timing_summary((iterations or self.opt.iterations) - start_iteration, total_s)
        return out

    def write_timing_summary(self, iterations: int, total_s: float) -> None:
        mp = getattr(self.model_params, "model_path", "") or ""
        if not mp:
            return
        event_s = sum(self.event_phase_s.values())
        # the trainer's thread spends an event's seconds on it, but a
        # worker's run beside training: there only the waits and the lift
        on_trainer = event_s
        if self.pipeline_guidance and self.event_worker:
            on_trainer = self.event_wait_s + self.event_phase_s["lift"]
        summary = {
            "iterations": iterations,
            "total_s": total_s,
            "train_s": total_s - on_trainer,
            "event_s": event_s,
            "events_run": self.events_run,
            "it_per_s": iterations / max(total_s, 1e-9),
            "train_res": [self.H, self.W],
            "event_phase_s": dict(self.event_phase_s),
            # pipelined events: the seconds finalize waited for the worker
            "event_wait_s": self.event_wait_s,
            "pipeline_guidance": self.pipeline_guidance,
            "engine": type(self.engine).__name__,
        }
        with open(os.path.join(mp, "timing_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
