"""Evaluate rendered test sets: SSIM, PSNR and LPIPS.

Counterpart of the reference `metrics.py`, with the same JSON artifacts
(`results.json`, `per_view.json` in each model directory):

    python -m guidedvd3dgs_tpu_torch.metrics -m <model_dir> [...] [--device cuda|cpu]

LPIPS-vgg takes the images in [0, 1] (`LPIPS`), LPIPS-alex in [-1, 1]
(`LPIPS_ALEX`, the paper's number), with the weights `utils/lpips.py`'s
load_lpips finds ($LPIPS_WEIGHTS_DIR or the torch hub cache). Without them
the LPIPS fields are null, with a warning, never zero.
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
from guidedvd3dgs_tpu_torch.utils.lpips import load_lpips
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


@torch.no_grad()
def evaluate(model_paths: List[str], device="cuda") -> None:
    device = resolve_device(str(device))
    lpips_vgg, lpips_alex = (None if m is None else m.to(device) for m in (load_lpips("vgg"), load_lpips("alex")))
    if lpips_vgg is None or lpips_alex is None:
        print("WARNING: LPIPS weights not found (set LPIPS_WEIGHTS_DIR); lpips fields will be null")
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict, per_view_dict = {}, {}
        test_dir = Path(scene_dir) / "test"
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names = read_images(method_dir / "renders", method_dir / "gt")
            ssims, psnrs, lpipss, lpipss_alex = [], [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(r).to(device)
                gt = torch.from_numpy(g).to(device)
                ssims.append(float(ssim_fn(rt[0], gt[0])))
                psnrs.append(float(psnr_fn(rt[0], gt[0])[0, 0]))
                if lpips_vgg is not None:
                    lpipss.append(float(lpips_vgg(rt, gt)[0]))
                if lpips_alex is not None:
                    lpipss_alex.append(float(lpips_alex(rt * 2 - 1, gt * 2 - 1)[0]))

            def mean(xs):
                return float(np.mean(xs)) if xs else None

            print(f"  SSIM : {mean(ssims):.7f}")
            print(f"  PSNR : {mean(psnrs):.7f}")
            if lpipss:
                print(f"  LPIPS: {mean(lpipss):.7f}")
            full_dict[method] = {
                "SSIM": mean(ssims),
                "PSNR": mean(psnrs),
                "LPIPS": mean(lpipss),
                "LPIPS_ALEX": mean(lpipss_alex),
            }
            per_view_dict[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)),
                "LPIPS_ALEX": dict(zip(names, lpipss_alex)),
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
