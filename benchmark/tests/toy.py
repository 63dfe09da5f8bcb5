"""Toy-sized cells for the CPU tests: the real configurations' files with
their widths cut to a few channels, run through the same drivers."""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import spec as spec_mod  # noqa: E402

CTX, EMB = 32, 48


def vc_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "viewcrafter-pvd1024.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["compute_dtype"] = "float32"
    cfg["unet"].update(model_channels=32, num_res_blocks=1, attention_resolutions=[1], channel_mult=[1],
                       num_head_channels=8, context_dim=CTX, temporal_length=4, image_tokens_per_frame=4)
    cfg["vae"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=32)
    cfg["clip_text"].update(width=CTX, heads=4, layers=2)
    cfg["clip_vision"].update(width=EMB, heads=4, layers=2, patch_size=32)
    cfg["resampler"].update(dim=CTX, depth=1, dim_head=8, heads=4, num_queries=4, embedding_dim=EMB,
                            output_dim=CTX, video_length=4)
    return cfg


def vc_spec(cell: str) -> spec_mod.Spec:
    """The cell's spec from BENCHMARK.json, with the toy configuration and
    a toy request (4 frames at 32 x 32, guidance at 48 x 64, 3 steps)."""
    spec = spec_mod.load(cell)
    spec.config = vc_config()
    spec.traffic = dict(spec.traffic, frames=4, height=32, width=32, guide_height=48, guide_width=64,
                        ddim_steps=3, decode_chunk=2, trace_steps=1)
    return spec


def context(spec, seed=5, seconds=0.5, trace=False, fault=None, calibrate=False, max_steps=0):
    import run

    return run.Context(spec=spec, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
                       t0=time.perf_counter(), max_steps=max_steps or (spec.traffic["trace_steps"] if trace else 0),
                       fault=fault, calibrate=calibrate)


def gs_spec(cell: str) -> spec_mod.Spec:
    """The cell's spec with the scene cut to a toy: 3000 Gaussians, three
    64 x 48 views; the same iterations."""
    spec = spec_mod.load(cell)
    spec.config = dict(spec.config, width=64, height=48, n_gaussians=3000, n_views=3, n_cams=12)
    spec.traffic = dict(spec.traffic, trace_steps=5)
    return spec
