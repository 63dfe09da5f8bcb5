#!/usr/bin/env python3
"""K5 (the tile blend backward) and K2 (the preprocess backward) of this
tree against another version of their sources, in turns, on one NVIDIA GPU.

    python3 scripts/gaussian_kernel_ab.py OLD_DIR [--variants NAME,...] [--side NAME=DIR ...]

OLD_DIR holds the other version's `blend_bwd.cu`, `preprocess_bwd.cu`,
`common.cuh` and `errors.cu`; for the parent commit, in a directory that
.gitignore lists:

    mkdir -p build/ab_old && for f in blend_bwd.cu preprocess_bwd.cu common.cuh errors.cu; do
      git show HEAD~1:guidedvd3dgs_tpu_torch/csrc/$f > build/ab_old/$f; done

Each side's two kernels are built with the package's nvcc flags into a
library of its own under build/ab/ (all compiles started together): "old"
from OLD_DIR, "new" from this tree's csrc/, each chosen entry of VARIANTS
(all by default) from this tree's source with one text substitution, and
each --side from a directory of other sources (files it lacks are taken
from csrc/). On phase 3's data of
chip_smoke.py (200,000 Gaussians, one 640x480 view) and on one view of
phase 5b's trained-density room (1,000,000 Gaussians), each side's C entry
is called with the same arguments and preallocated outputs, and the script
prints:

- whether every side's K5 rows and K2 gradients are bitwise equal to
  "new"'s;
- each side's ms by CUDA events over 20 launches, queued behind a sleep,
  in turns (old, new, variants..., variants..., new, old);
- the tail: each side's K5 with only the tile of the longest walk left,
  that tile's latency on an otherwise idle card, against the whole kernel;
  and "new"'s K5 without that tile and without the 1% of longest walks;
- tile_count and walk statistics of each view, and ptxas's registers,
  shared memory and stack of every side's kernels.

The last line is a JSON object of every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from guidedvd3dgs_tpu_torch.ops import _build, preprocess_fused  # noqa: E402

SOURCES = ("blend_bwd.cu", "preprocess_bwd.cu", "errors.cu")
# name: (source, text in this tree's source, its replacement); the
# "no_" ones are ablations that drop a part of the work to time the rest
# (their outputs are wrong, and the bitwise check says so)
VARIANTS = {
    "k5_row_order": ("blend_bwd.cu", "const int t = tile_order[blockIdx.x];", "const int t = blockIdx.x;"),
    "k5_sub32": ("blend_bwd.cu", "constexpr int SUB = 64;", "constexpr int SUB = 32;"),
    "k5_min4blocks": ("blend_bwd.cu", "__launch_bounds__(TILE_PIX)", "__launch_bounds__(TILE_PIX, 4)"),
    "k5_no_sums": ("blend_bwd.cu", "sum = warp_sums2(s, lane);",
                   "for (int f = 0; f < 2 * NS; ++f) sum += s[f];"),
    "k2_256threads": ("preprocess_bwd.cu", "constexpr int K2_THREADS = 128;",
                      "constexpr int K2_THREADS = 256;"),
    "k2_64threads": ("preprocess_bwd.cu", "constexpr int K2_THREADS = 128;",
                     "constexpr int K2_THREADS = 64;"),
    "k2_min4blocks": ("preprocess_bwd.cu", "constexpr int K2_MIN_BLOCKS = 3;", "constexpr int K2_MIN_BLOCKS = 4;"),
    "k2_no_sweep": ("preprocess_bwd.cu", "    grad_one<D>(s_mean", "    if (i < 0) grad_one<D>(s_mean"),
}
OUT = ROOT / "build" / "ab"


def source_dir(name: str, files: dict[str, str]) -> Path:
    """build/ab/src/<name>: csrc/'s sources with `files` ({name: text}) over them."""
    d = OUT / "src" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in list(SOURCES) + ["common.cuh"]:
        (d / f).write_text(files.get(f, (_build.CSRC / f).read_text()))
    return d


def prepare(old_dir: Path, variants: list[str], sides: list[str]) -> dict[str, Path]:
    """The source directory of every side."""
    dirs = {"old": source_dir("old", {f: (old_dir / f).read_text() for f in SOURCES + ("common.cuh",)
                                      if (old_dir / f).exists()}),
            "new": _build.CSRC}
    for name in variants:
        src, text, repl = VARIANTS[name]
        body = (_build.CSRC / src).read_text()
        if body.count(text) != 1:
            raise RuntimeError(f"variant {name}: {text!r} is not in {src} once")
        dirs[name] = source_dir(name, {src: body.replace(text, repl)})
    for side in sides:
        name, path = side.split("=", 1)
        path = Path(path).resolve()
        dirs[name] = source_dir(name, {f: (path / f).read_text() for f in SOURCES + ("common.cuh",)
                                       if (path / f).exists()})
    return dirs


def build_all(dirs: dict[str, Path]) -> dict[str, tuple[Path, str]]:
    """One library per side, every nvcc started together. Returns
    {side: (library, ptxas output)}."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    jobs = {}
    for side, d in dirs.items():
        (OUT / side).mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            obj = OUT / side / f"{Path(src).stem}.o"
            cmd = [_build._nvcc(), *flags, "-I", str(d), "-I", str(_build.CSRC), "-c", "-o", str(obj),
                   str(d / src)]
            jobs[(side, src)] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True))
    logs = {side: "" for side in dirs}
    for (side, src), (_, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {side}/{src}:\n{out}")
        logs[side] += out
    libs = {}
    for side in dirs:
        lib = OUT / side / "libab.so"
        objs = [str(obj) for (s, _), (obj, _) in jobs.items() if s == side]
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:2], "-shared", "-o", str(lib), *objs],
                       check=True, capture_output=True, text=True)
        libs[side] = (lib, logs[side])
    return libs


def load(path: Path, src_dir: Path) -> ctypes.CDLL:
    """The side's library; `lib.tile_order` says whether its K5 takes the
    order of its tiles (an argument after tile_count)."""
    lib = ctypes.CDLL(str(path))
    lib.tile_order = "tile_order" in (src_dir / "blend_bwd.cu").read_text()
    for name in ("blend_bwd", "preprocess_bwd"):
        fn = getattr(lib, f"gvd_{name}")
        argtypes = list(_build.SIGNATURES[name])
        if name == "blend_bwd" and not lib.tile_order:
            del argtypes[6]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def calls(lib, k5_args, k2_args, tile_count=None):
    """(k5, k2, outputs): closures that launch `lib`'s K5 and K2 on the
    arguments of chip_smoke.bwd_inputs, into outputs allocated here (K5's
    rows zeroed once: the kernel writes the rows it reaches and no other;
    its tiles in the order the package's wrapper gives them)."""
    tab, binning, color, depth, alpha, dC, dD, dA, w, h = k5_args
    counts = binning.tile_count if tile_count is None else tile_count
    order = [torch.argsort(counts, descending=True, stable=True).to(torch.int32)] if lib.tile_order else []
    grad = torch.zeros((binning.num_instances, 10), device=tab.device)
    means, scales, rots, opac, shs, cam, sh_degree, sm, cot = k2_args
    camc = preprocess_fused.cam_consts(cam)
    g = [torch.empty_like(t) for t in (means, scales, rots, opac, shs)]
    stream = _build.stream_of(tab)

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")

    def k5():
        check(lib.gvd_blend_bwd(tab.data_ptr(), tab.shape[1], binning.inst_gauss.data_ptr(),
                                binning.perm.data_ptr(), binning.tile_start.data_ptr(), counts.data_ptr(),
                                *[t.data_ptr() for t in order], color.data_ptr(), depth.data_ptr(),
                                alpha.data_ptr(), dC.data_ptr(), dD.data_ptr(), dA.data_ptr(), binning.grid_x,
                                binning.grid_y, w, h, grad.data_ptr(), stream), "K5")

    def k2():
        check(lib.gvd_preprocess_bwd(means.data_ptr(), scales.data_ptr(), rots.data_ptr(), shs.data_ptr(),
                                     camc.data_ptr(), cot.data_ptr(), means.shape[0], shs.shape[1], sh_degree,
                                     sh_degree, sm, cam.width, cam.height, *[t.data_ptr() for t in g],
                                     stream), "K2")

    return k5, k2, (grad, g)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("old_dir", type=Path, help="the other version's sources")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names of VARIANTS to build (default: all; '' for none)")
    parser.add_argument("--side", action="append", default=[], metavar="NAME=DIR",
                        help="another side built from the sources in DIR")
    args = parser.parse_args()
    dev = cs.phase_device()
    variants = [v for v in args.variants.split(",") if v]
    dirs = prepare(args.old_dir.resolve(), variants, args.side)
    libs = build_all(dirs)
    result = {"ptxas": {}, "views": {}}
    for side, (_, log) in libs.items():
        lines = [ln for ln in cs.ptxas_summary(log) if "bwd_kernel" in ln and "flash" not in ln]
        result["ptxas"][side] = lines
        print(f"ptxas {side}: " + "; ".join(lines), flush=True)
    loaded = {side: load(path, dirs[side]) for side, (path, _) in libs.items()}
    sides = list(loaded)
    turns = sides + sides[::-1]

    params, cam, bg = cs.kernel_check_view(dev)
    views = {"phase 3": cs.view_inputs(params, cam, bg, cs.SEED)}
    del params
    _, pcams, dense = cs.dense_room(dev)
    views["phase 5b"] = cs.view_inputs(dense, cs.dense_view(pcams, dev), torch.zeros(3, device=dev),
                                       cs.SEED + 3)
    del dense
    for view, (k5_args, k2_args) in views.items():
        tab, binning = k5_args[:2]
        blended, culled, walks = cs.evaluated_pairs(tab, binning, cs.WIDTH, cs.HEIGHT)
        runs = {side: calls(lib, k5_args, k2_args) for side, lib in loaded.items()}
        for k5, k2, _ in runs.values():
            k5()
            k2()
        torch.cuda.synchronize()
        ref_grad, ref_g = runs["new"][2]
        equal = {side: {"K5": bool(torch.equal(grad, ref_grad)),
                        "K2": all(torch.equal(a, b) for a, b in zip(g, ref_g))}
                 for side, (_, _, (grad, g)) in runs.items()}
        ms = {side: {"K5": [], "K2": []} for side in sides}
        for side in turns:
            k5, k2, _ = runs[side]
            ms[side]["K5"].append(cs.event_ms(k5))
            ms[side]["K2"].append(cs.event_ms(k2))
        heavy = int(walks.argmax())
        alone = torch.zeros_like(binning.tile_count)
        alone[heavy] = binning.tile_count[heavy]
        tail_ms = {side: cs.event_ms(calls(lib, k5_args, k2_args, tile_count=alone)[0])
                   for side, lib in loaded.items()}
        without = {}
        for name, drop in (("longest", walks == walks.max()),
                           ("longest 1%", walks >= torch.quantile(walks.float(), 0.99))):
            counts = torch.where(drop.to(binning.tile_count.device), 0, binning.tile_count)
            without[name] = (int(drop.sum()), cs.event_ms(calls(loaded["new"], k5_args, k2_args,
                                                                 tile_count=counts)[0]))
        k5_bound, k2_bound = cs.k5_bound(k5_args, blended, culled), cs.k2_bound(k2_args)
        stats = cs.tile_stats(binning, walks)
        result["views"][view] = dict(
            gaussians=tab.shape[1], instances=binning.num_instances, blended=blended, walked=blended + culled,
            tiles=stats, bitwise_equal_to_new=equal, ms=ms, k5_bound=k5_bound, k2_bound=k2_bound,
            tail=dict(tile=heavy, tile_count=int(binning.tile_count[heavy]), walk=int(walks[heavy]),
                      ms=tail_ms, new_without=without))
        print(f"{view} ({tab.shape[1]} Gaussians, {binning.num_instances} instances, pairs walked "
              f"{blended + culled}, blended {blended}; {stats}): bitwise equal to new {equal} | "
              f"CUDA events over {cs.EVENT_LAUNCHES} launches, turns {' '.join(turns)}: "
              + " | ".join(f"{side} K5 {' / '.join(f'{t:.4f}' for t in ms[side]['K5'])} ms, "
                           f"K2 {' / '.join(f'{t:.4f}' for t in ms[side]['K2'])} ms" for side in sides)
              + f" | bounds K5 {k5_bound[0]:.4f} ms ({k5_bound[1]}), K2 {k2_bound[0]:.4f} ms ({k2_bound[1]})"
              f" | K5 on tile {heavy} alone (count {int(binning.tile_count[heavy])}, walk "
              f"{int(walks[heavy])}): " + ", ".join(f"{side} {t:.4f} ms" for side, t in tail_ms.items())
              + " | new K5 without " + ", ".join(f"the {name} ({n} tiles) {t:.4f} ms"
                                                 for name, (n, t) in without.items()), flush=True)
        del runs
    print(json.dumps(result))


if __name__ == "__main__":
    main()
