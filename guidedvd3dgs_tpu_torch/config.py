"""Typed config tree and the reflection CLI.

Counterpart of `guidedvd3dgs_tpu/config.py`, trimmed to what the port's
CLIs call: every dataclass field becomes a flag (bools become store_true
pairs with a `--no_` counterpart, the fields in SHORTHANDS also get
one-letter flags), configs persist as `<model>/cfg_args.json`, and a
reference-style `cfg_args` (a repr'd argparse.Namespace) is parsed
through the AST, never eval(). The field lists are the reference
package's, so a model directory written by either package reads in both.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
from dataclasses import dataclass, fields
from typing import Optional

# one-letter shorthands, mirroring the original's leading-underscore names
SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "resolution": "r",
    "white_background": "w",
}


@dataclass
class ParamGroup:
    """Base: reflection between dataclass fields and argparse flags."""

    @classmethod
    def add_to_parser(cls, parser: argparse.ArgumentParser, fill_none: bool = False):
        group = parser.add_argument_group(cls.__name__)
        for f in fields(cls):
            default = None if fill_none else f.default
            names = [f"--{f.name}"]
            if f.name in SHORTHANDS:
                names.append(f"-{SHORTHANDS[f.name]}")
            if f.type in ("bool", bool):
                group.add_argument(*names, default=default, action="store_true")
                # a True-default bool can be switched off from the CLI
                group.add_argument(
                    f"--no_{f.name}", dest=f.name, action="store_false",
                    default=argparse.SUPPRESS, help=argparse.SUPPRESS,
                )
            else:
                ftype = {"int": int, "float": float, "str": str}.get(f.type, None)
                if ftype is None:
                    ftype = f.type if callable(f.type) else str
                group.add_argument(*names, default=default, type=ftype)

    @classmethod
    def extract(cls, args: argparse.Namespace):
        kwargs = {}
        for f in fields(cls):
            v = getattr(args, f.name, None)
            if v is None:
                v = f.default if f.default is not dataclasses.MISSING else f.default_factory()
            kwargs[f.name] = v
        return cls(**kwargs)


@dataclass
class ModelParams(ParamGroup):
    """Scene and data parameters."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"  # CLI compatibility; images live on the host
    eval: bool = True
    n_views: int = 6
    dataset: str = "replica"  # replica | colmap (the readers the port has)
    train_bg: bool = False  # CLI compatibility
    use_dust3r_init: bool = True  # CLI compatibility
    demo_setting: bool = False  # Replica project-page split (test == train anchors)
    dust3r_ply: str = ""  # precomputed points3D.ply overriding the scene's own


@dataclass
class PipelineParams(ParamGroup):
    """Render pipeline toggles."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    use_confidence: bool = False
    use_color: bool = True
    raster_backend: str = "auto"  # auto | dense | tiles


@dataclass
class OptimizationParams(ParamGroup):
    """3DGS and guidance hyperparameters with the reference defaults. The
    guidance fields are parsed (so one command line serves both packages)
    but only the baseline fields are read by the port so far."""

    iterations: int = 10_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 10_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    prune_from_iter: int = 500
    densify_until_iter: int = 10_000
    densify_grad_threshold: float = 0.0005
    prune_threshold: float = 0.005
    start_sample_pseudo: int = 2000
    end_sample_pseudo: int = 9500
    sample_pseudo_interval: int = 1
    dist_thres: float = 10.0

    project_cam_prob: float = 0.8
    project_cam_weight: float = 0.05

    pseudo_cam_weight: float = 0.05
    pseudo_cam_ssim: bool = False
    pseudo_cam_lpips: bool = True
    pseudo_cam_lpips_weight: float = 0.1
    pseudo_cam_weight_decay: bool = False
    pseudo_cam_weight_start: float = 10.0
    pseudo_cam_weight_end: float = 0.05

    use_trajectory_pool: bool = True

    guidance_recon_loss: str = "l2"
    w_guidance_recon_loss: float = 0.5
    guidance_gpu_id: int = 1
    guidance_tp: int = 1
    guidance_vd_iter: int = 260
    guidance_ddim_steps: int = 50
    guidance_pc_render_all_views: bool = False
    guidance_recur_steps: int = 1
    guidance_vc_center_scale: float = 1.0

    no_guidance: bool = False
    guidance_random_traj: bool = False
    guidance_no_wave_traj: bool = False
    guidance_with_training_gs: bool = False
    guidance_with_training_gs_startiter: int = 5999
    guidance_with_training_gs_decide_mask: bool = False
    guidance_with_ssim: bool = False
    guidance_mean_loss: bool = False
    guidance_with_lpips: bool = False
    guidance_verbose: bool = False
    guidance_videos_from_file: bool = False
    guidance_save_videos: bool = True
    save_pred_x0: bool = False
    append_pcd_from_video_diffusion: bool = False
    scale_guidance_weight: bool = False
    scannetpp_newres: bool = False
    replace_diffusion_input_with_gsrender: bool = False

    txt_traj_warmup: bool = False

    gaussian_capacity: int = 0  # CLI compatibility: the port sizes tensors exactly
    seed: int = 1


def build_parser(fill_none: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    ModelParams.add_to_parser(parser, fill_none)
    PipelineParams.add_to_parser(parser, fill_none)
    OptimizationParams.add_to_parser(parser, fill_none)
    return parser


def save_cfg_args(model_path: str, merged: argparse.Namespace):
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(vars(merged), f, indent=1, default=str)


def parse_namespace_repr(text: str) -> dict:
    """Parse a reference-style cfg_args file (the repr of an
    argparse.Namespace) without eval()."""
    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if not isinstance(call, ast.Call):
        raise ValueError("cfg_args is not a Namespace repr")
    return {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}


def load_persisted_cfg(model_path: str) -> dict:
    """The config of a model directory: cfg_args.json, or a reference
    cfg_args Namespace repr."""
    jpath = os.path.join(model_path, "cfg_args.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            return json.load(f)
    npath = os.path.join(model_path, "cfg_args")
    if os.path.exists(npath):
        with open(npath) as f:
            return parse_namespace_repr(f.read())
    raise FileNotFoundError(f"no cfg_args[.json] under {model_path}")


def get_combined_args(parser_args: argparse.Namespace, model_path: Optional[str] = None):
    """Merge CLI args with the persisted training config, CLI winning."""
    mp = model_path or parser_args.model_path
    merged = dict(load_persisted_cfg(mp))
    for k, v in vars(parser_args).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
