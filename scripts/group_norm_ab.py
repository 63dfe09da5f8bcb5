#!/usr/bin/env python3
"""Kernel N1 (GroupNorm + SiLU, csrc/group_norm.cu) alone against the plain
fold it replaces, forward and backward, on one NVIDIA GPU, across grid
sizes.

    python3 scripts/group_norm_ab.py [--blocks-per-sm 2,4,8] [--out build/group_norm_ab.json]

Phase 7d of chip_smoke.py measures N1 at the main path's shapes with the
grid the program uses; this script reuses its checks and timers
(`n1_check`, `n1_times`, `n1_plain_times`, `n1_bounds`) to sweep the grid
target (`blocks_per_sm`, ops/group_norm.py's BLOCKS_PER_SM the default)
at more of the ViewCrafter's shapes in bf16 (random weights; 32 groups):
chip_smoke's N1_SHAPES, the UNet's temporal form for 2 videos, level 1
(25 frames of 20x28x640) and level 3 (25 frames of 5x7x1280). For each
shape, with and without SiLU, it prints and writes:

- the kernels' forward and backward ms by CUDA events at each grid target;
- the plain fold's forward (its SiLU included) and its backward through
  autograd;
- the bounds: the bytes the function needs (4 an element forward, 6
  backward) and this design's traffic (6 and 10), at 3.35 TB/s, and the
  best time's share of the first;
- the largest error over its tolerance each way (tests/group_norm_tol.py);
- at the smallest shape, the host's microseconds a call in a loop of 200
  calls (the kernel path as `nnops.group_norm` takes it, without
  autograd, and the plain fold), where the card waits for the host.

Phases 1 and 2 of chip_smoke.py print the card, its power limit and
ptxas's registers of every kernel first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import group_norm as gn  # noqa: E402

SHAPES = {
    "vae_320x448x128": cs.N1_SHAPES[0],
    "unet_l0_pair": cs.N1_SHAPES[1],
    "unet_l0_temporal_b1": cs.N1_SHAPES[2],
    "unet_l0_temporal": ((2, 25, 40, 56, 320), 1e-5),
    "unet_l1": ((25, 20, 28, 640), 1e-5),
    "unet_l3": ((25, 5, 7, 1280), 1e-5),
}
HOST_SHAPE = "unet_l3"  # the host's time a call, where the card's is least
HOST_CALLS = 200


def host_us(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def one_shape(label, shape, eps, silu, variants, dev) -> dict:
    x, w, b, dy = cs.n1_inputs(dev, shape, cs.SEED)
    bounds = cs.n1_bounds(x.numel())
    row = dict(shape=list(shape), silu=silu, elements=x.numel(),
               **{f"{k}_ms": v[0] for k, v in bounds.items()}, **cs.n1_check(x, w, b, dy, eps, silu))
    for bps in variants:
        t = cs.n1_times(x, w, b, dy, eps, silu, bps)
        row[f"kernel_fwd_ms@{bps}"], row[f"kernel_bwd_ms@{bps}"] = t["fwd"], t["bwd"]
        n, c = shape[0], shape[-1]
        row[f"grid@{bps}"] = list(gn.geometry(n, x.numel() // (n * c), c, gn._sms(0), bps))
    plain = cs.n1_plain_times(x, w, b, dy, eps, silu)
    row["plain_fwd_ms"], row["plain_bwd_ms"] = plain["fwd"], plain["bwd"]
    if label == HOST_SHAPE:
        g = cs.N1_GROUPS
        row["host_us_kernel"] = host_us(lambda: gn.group_norm(x, w, b, g, eps, silu))
        row["host_us_plain"] = host_us(lambda: gn.group_norm_plain(x, w, b, g, eps, silu))
    for way in ("fwd", "bwd"):
        best = min(row[f"kernel_{way}_ms@{v}"] for v in variants)
        row[f"share_of_bound_{way}"] = row[f"{way}_ms"] / best
    del x, w, b, dy
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks-per-sm", default=str(gn.BLOCKS_PER_SM))
    ap.add_argument("--out", default="build/group_norm_ab.json")
    args = ap.parse_args(argv)
    dev = cs.phase_device()
    cs.phase_build()
    variants = [int(v) for v in args.blocks_per_sm.split(",")]
    result = dict(device=torch.cuda.get_device_name(0), torch=torch.__version__, rows={})
    for label, (shape, eps) in SHAPES.items():
        for silu in (False, True):
            row = one_shape(label, shape, eps, silu, variants, dev)
            result["rows"][f"{label}{'+silu' if silu else ''}"] = row
            times = " ".join(f"k{v} {row[f'kernel_fwd_ms@{v}']:.4f}/{row[f'kernel_bwd_ms@{v}']:.4f}"
                             for v in variants)
            print(f"{label:20s} silu={int(silu)} fwd/bwd ms: {times} | plain {row['plain_fwd_ms']:.4f}/"
                  f"{row['plain_bwd_ms']:.4f} | bound {row['fwd_ms']:.4f}/{row['bwd_ms']:.4f} "
                  f"({100 * row['share_of_bound_fwd']:.1f}% / {100 * row['share_of_bound_bwd']:.1f}%; design's "
                  f"traffic {row['design_fwd_ms']:.4f}/{row['design_bwd_ms']:.4f}) | err/tol "
                  f"{row['fwd_err_over_tol']:.3f}/{row['bwd_err_over_tol']:.3f}", flush=True)
            if "host_us_kernel" in row:
                print(f"  host us a call: kernel {row['host_us_kernel']:.1f}, plain {row['host_us_plain']:.1f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
