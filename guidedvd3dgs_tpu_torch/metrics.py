"""Evaluate rendered test sets: SSIM and PSNR.

Counterpart of the reference `metrics.py`, with the same JSON artifacts
(`results.json`, `per_view.json` in each model directory):

    python -m guidedvd3dgs_tpu_torch.metrics -m <model_dir> [...] [--device cuda|cpu]

LPIPS needs external network weights and is not ported yet: its fields
are null, with a warning, never zero.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.render import resolve_device
from guidedvd3dgs_tpu_torch.utils.image_io import load_image
from guidedvd3dgs_tpu_torch.utils.losses import psnr as psnr_fn
from guidedvd3dgs_tpu_torch.utils.losses import ssim as ssim_fn


def read_images(renders_dir: Path, gt_dir: Path):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = load_image(str(renders_dir / fname)).astype(np.float32) / 255.0
        g = load_image(str(gt_dir / fname)).astype(np.float32) / 255.0
        renders.append(np.transpose(r, (2, 0, 1))[None])
        gts.append(np.transpose(g, (2, 0, 1))[None])
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths: List[str], device="cuda") -> None:
    device = resolve_device(str(device))
    print("WARNING: LPIPS weights not found (set LPIPS_WEIGHTS_DIR); lpips fields will be null")
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict, per_view_dict = {}, {}
        test_dir = Path(scene_dir) / "test"
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names = read_images(method_dir / "renders", method_dir / "gt")
            ssims, psnrs = [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(r[0]).to(device)
                gt = torch.from_numpy(g[0]).to(device)
                ssims.append(float(ssim_fn(rt, gt)))
                psnrs.append(float(psnr_fn(rt, gt)[0, 0]))

            def mean(xs):
                return float(np.mean(xs)) if xs else None

            print(f"  SSIM : {mean(ssims):.7f}")
            print(f"  PSNR : {mean(psnrs):.7f}")
            full_dict[method] = {
                "SSIM": mean(ssims),
                "PSNR": mean(psnrs),
                "LPIPS": None,
                "LPIPS_ALEX": None,
            }
            per_view_dict[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": {},
                "LPIPS_ALEX": {},
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict, f, indent=2)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, device=args.device)


if __name__ == "__main__":
    main()
