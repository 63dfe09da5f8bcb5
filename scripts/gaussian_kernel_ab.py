#!/usr/bin/env python3
"""The Gaussian kernels K1 (preprocess forward), K3 (instance expansion),
K4 (tile blend forward), K5 (tile blend backward), K6 (per-Gaussian
gradient sum) and K2 (preprocess backward) of this tree against another
version of their sources, in turns, on one NVIDIA GPU.

    python3 scripts/gaussian_kernel_ab.py OLD_DIR [--variants NAME,...] [--side NAME=DIR ...]

OLD_DIR holds the other version's `preprocess_fwd.cu`, `expand.cu`,
`blend_fwd.cu`, `blend_bwd.cu`, `segsum.cu`, `preprocess_bwd.cu`,
`common.cuh` and `errors.cu`; for the parent commit, in a directory that
.gitignore lists:

    mkdir -p build/ab_old && for f in preprocess_fwd.cu expand.cu blend_fwd.cu blend_bwd.cu segsum.cu \
        preprocess_bwd.cu common.cuh errors.cu; do
      git show HEAD~1:guidedvd3dgs_tpu_torch/csrc/$f > build/ab_old/$f; done

Each side's kernels are built with the package's nvcc flags into a
library of its own under build/ab/ (all compiles started together): "old"
from OLD_DIR, "new" from this tree's csrc/, each chosen entry of VARIANTS
(all by default) from this tree's sources with its text substitutions or
with one source replaced by a file of scripts/ab_variants/, and each
--side from a directory of other sources (files it lacks are taken from
csrc/). On phase 3's data of chip_smoke.py (200,000 Gaussians,
one 640x480 view) and on one view of phase 5b's trained-density room
(1,000,000 Gaussians), each side's C entries are called with the same
arguments and preallocated outputs (an old K4 without the tile order, an
old K3 without the instance total, an old K1 and K2 with one SH tensor,
as their signatures were), and the script prints:

- whether every side's K1 table, K3 keys, owners and histogram, K4 color,
  depth and alpha, K5 rows, K6 sums and K2 gradients are bitwise equal to
  "new"'s. K1 runs on one (N, K, 3) SH tensor and the full table (`K1`)
  and, where its signature has them, as the tile rasterizer calls it
  (`K1s`): SH from the two tensors features_dc and features_rest, rows 6-8
  of the Gaussians that no tile holds skipped. `K1s` is held to "new"'s
  full table on every row but those, which must be zero. K2 reads its SH
  from the two tensors where its signature has them, from one tensor
  elsewhere; its SH gradient is compared as one (N, K, 3) tensor. K6 sums
  "new"'s K5 rows of the view; where its sums are not bitwise "new"'s
  (one side summing a Gaussian's slots by a warp, the other in slot
  order), the script also prints, for each side, whether they lie within
  phase 3's k6_tol (count 2^-23 sum |g|) of the float64 sums and whether
  the sums of the Gaussians of at most one slot are bitwise "old"'s, and
  whether "new"'s sums are the same bits after the timed launches (run to
  run), with the Gaussians of two slots or more counted;
- each side's ms of each kernel by CUDA events over 20 launches, queued
  behind a sleep, in turns (old, new, variants..., variants..., new, old);
  K3's calls include the zeroing of its histogram, as the wrapper's do;
- the tail: each side's K4 and K5 with only the tile of the longest walk
  left, that tile's latency on an otherwise idle card, against the whole
  kernel; and "new"'s K5 without that tile and without the 1% of longest
  walks;
- what K4's gather costs: "old"'s and "new"'s K4 on a copy of the table
  gathered beforehand into instance order (the same fields, so the same
  walk and bits, read from consecutive addresses);
- tile_count and walk statistics of each view, K3's windows there (the
  spans of Gaussian indices their owners cover, the Gaussians in view,
  the longest run out of view), and ptxas's registers, shared memory and
  stack of every side's kernels.

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
from guidedvd3dgs_tpu_torch.ops import _build, preprocess_fused, raster_tiles, segsum, tiling  # noqa: E402

SOURCES = ("preprocess_fwd.cu", "expand.cu", "blend_fwd.cu", "blend_bwd.cu", "segsum.cu",
           "preprocess_bwd.cu", "errors.cu")
# the kernels of each side, by the key of its readings and its C entry
KERNELS = {"K1": "preprocess_fwd", "K3": "expand", "K4": "blend_fwd", "K5": "blend_bwd",
           "K6": "segsum", "K2": "preprocess_bwd"}
# the signatures of K1 and K2 with one SH tensor (before the SH pair)
_P, _I, _F = _build._P, _build._I, _build._F
ONE_TENSOR_SIGNATURES = {
    "preprocess_fwd": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P],
    "preprocess_bwd": [_P] * 6 + [_I] * 4 + [_F, _I, _I] + [_P] * 5 + [_P],
}
# K4 taking its tiles from an atomic counter in the order of tile_order: a
# grid of the blocks resident at once, each block taking tiles until none
# is left; the last block to finish resets the counter for the next launch
K4_PERSISTENT = (
    ("__global__ void __launch_bounds__(TILE_PIX, K4_MIN_BLOCKS)",
     "__device__ int g_next_tile = 0, g_left = 0;\n__global__ void __launch_bounds__(TILE_PIX, K4_MIN_BLOCKS)"),
    ("const float* __restrict__ bg, int gx,", "const float* __restrict__ bg, int gx, int num_tiles,"),
    ("  const int t = tile_order[blockIdx.x];",
     "  __shared__ int s_i;\n  for (;;) {\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) s_i = atomicAdd(&g_next_tile, 1);\n  __syncthreads();\n"
     "  if (s_i >= num_tiles) break;\n  const int t = tile_order[s_i];"),
    ("    out_alpha[qa] = acc_a;\n  }\n}",
     "    out_alpha[qa] = acc_a;\n  }\n  }\n"
     "  if (threadIdx.x == 0 && atomicAdd(&g_left, 1) == (int)gridDim.x - 1) {\n"
     "    g_next_tile = 0;\n    g_left = 0;\n  }\n}"),
    ("    gvd::blend_fwd_kernel<<<num_tiles, gvd::TILE_PIX, 0, stream>>>(\n"
     "        tab, n, inst_gauss, tile_start, tile_count, tile_order, bg, gx, width,",
     "    int dev = 0, sms = 0, per_sm = 0;\n    cudaGetDevice(&dev);\n"
     "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
     "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gvd::blend_fwd_kernel, gvd::TILE_PIX, 0);\n"
     "    const int grid = sms * per_sm < num_tiles ? sms * per_sm : num_tiles;\n"
     "    gvd::blend_fwd_kernel<<<grid, gvd::TILE_PIX, 0, stream>>>(\n"
     "        tab, n, inst_gauss, tile_start, tile_count, tile_order, bg, gx, num_tiles, width,"),
)
# K4 written over arrays of PP pixels a thread, at PP = 2
TWO_PIXELS = ROOT / "scripts" / "ab_variants" / "blend_fwd_two_pixels.cu"
# K1 before its redesign with only a template on sh_degree (the old signature)
K1_TEMPLATE = ROOT / "scripts" / "ab_variants" / "preprocess_fwd_template.cu"
# K4's scalar stop test as the array form has it: a separate all_done, set
# at the end of each step of U instances
K4_ALL_DONE = (
    ("    if (__syncthreads_count(done) == TILE_PIX) break;",
     "    bool all_done = done;\n    if (__syncthreads_count(all_done) == TILE_PIX) break;"),
    ("    for (int k = 0; k < nb && !done; k += U) {", "    for (int k = 0; k < nb && !all_done; k += U) {"),
    ("        T = test_t;\n      }\n    }\n", "        T = test_t;\n      }\n      all_done = done;\n    }\n"),
)
K4_NO_MIN_BLOCKS = (("__launch_bounds__(TILE_PIX, K4_MIN_BLOCKS)", "__launch_bounds__(TILE_PIX)"),)
# name: (source, ((text in this tree's source, its replacement), ...)[, a
# file that takes the source's place before the substitutions]); the "no_"
# ones are ablations that drop a part of the work to time the rest (their
# outputs are wrong, and the bitwise check says so)
VARIANTS = {
    "k4_two_pixels": ("blend_fwd.cu", (), TWO_PIXELS),
    "k4_pp1": ("blend_fwd.cu", (("constexpr int PP = 2;", "constexpr int PP = 1;"),), TWO_PIXELS),
    "k4_break": ("blend_fwd.cu", K4_NO_MIN_BLOCKS + (
        ("if (done || !(power[u] <= 0.0f)", "if (!(power[u] <= 0.0f)"),
        ("          done = true;\n          continue;", "          done = true;\n          break;"))),
    "k4_ids_all": ("blend_fwd.cu", K4_NO_MIN_BLOCKS + (
        ("    if (lin < ROUND) id = base + lin < cnt", "    id = base + lin < cnt"),)),
    "k4_alldone1": ("blend_fwd.cu", (("constexpr int K4_MIN_BLOCKS = 5;", "constexpr int K4_MIN_BLOCKS = 1;"),)
                    + K4_ALL_DONE),
    "k4_alldone5": ("blend_fwd.cu", K4_ALL_DONE),
    "k4_u1": ("blend_fwd.cu", (("constexpr int U = 4;", "constexpr int U = 1;"),)),
    "k4_u2": ("blend_fwd.cu", (("constexpr int U = 4;", "constexpr int U = 2;"),)),
    "k4_u8": ("blend_fwd.cu", (("constexpr int U = 4;", "constexpr int U = 8;"),)),
    "k4_round256": ("blend_fwd.cu", (("constexpr int ROUND = 128;", "constexpr int ROUND = 256;"),)),
    "k4_min8blocks": ("blend_fwd.cu", (("constexpr int K4_MIN_BLOCKS = 5;", "constexpr int K4_MIN_BLOCKS = 8;"),)),
    "k4_row_order": ("blend_fwd.cu", (("const int t = tile_order[blockIdx.x];", "const int t = blockIdx.x;"),)),
    "k4_persistent": ("blend_fwd.cu", K4_PERSISTENT),
    "k3_sample_always": ("expand.cu", (("      if (b - a < SCAN_MAX) {", "      if (false) {"),)),
    "k3_global_hist": ("expand.cu", (("const bool shared_hist = num_tiles <= gvd::HIST_CAP;",
                                      "const bool shared_hist = false;"),)),
    "k3_scan_to_4096": ("expand.cu", (("constexpr int SCAN_ITERS = 4;", "constexpr int SCAN_ITERS = 8;"),)),
    "k3_min2blocks": ("expand.cu", (("constexpr int K3_MIN_BLOCKS = 3;", "constexpr int K3_MIN_BLOCKS = 2;"),)),
    "k3_min4blocks": ("expand.cu", (("constexpr int K3_MIN_BLOCKS = 3;", "constexpr int K3_MIN_BLOCKS = 4;"),)),
    "k3_256threads": ("expand.cu", (("constexpr int K3_THREADS = 512;", "constexpr int K3_THREADS = 256;"),
                                    ("constexpr int K3_MIN_BLOCKS = 3;", "constexpr int K3_MIN_BLOCKS = 6;"))),
    "k5_row_order": ("blend_bwd.cu", (("const int t = tile_order[blockIdx.x];", "const int t = blockIdx.x;"),)),
    "k5_sub32": ("blend_bwd.cu", (("constexpr int SUB = 64;", "constexpr int SUB = 32;"),)),
    "k5_min4blocks": ("blend_bwd.cu", (("__launch_bounds__(TILE_PIX)", "__launch_bounds__(TILE_PIX, 4)"),)),
    "k5_no_sums": ("blend_bwd.cu", (("sum = warp_sums2(s, lane);",
                                     "for (int f = 0; f < 2 * NS; ++f) sum += s[f];"),)),
    "k2_256threads": ("preprocess_bwd.cu", (("constexpr int K2_THREADS = 128;", "constexpr int K2_THREADS = 256;"),)),
    "k2_64threads": ("preprocess_bwd.cu", (("constexpr int K2_THREADS = 128;", "constexpr int K2_THREADS = 64;"),)),
    "k2_min4blocks": ("preprocess_bwd.cu", (("constexpr int K2_MIN_BLOCKS = 3;", "constexpr int K2_MIN_BLOCKS = 4;"),)),
    "k2_no_sweep": ("preprocess_bwd.cu", (("    grad_one<D>(s_mean", "    if (i < 0) grad_one<D>(s_mean"),)),
    "k1_template_only": ("preprocess_fwd.cu", (), K1_TEMPLATE),
    "k1_64threads": ("preprocess_fwd.cu", (("constexpr int K1_THREADS = 128;", "constexpr int K1_THREADS = 64;"),)),
    "k6_256threads": ("segsum.cu", (("constexpr int K6_THREADS = 128;", "constexpr int K6_THREADS = 256;"),)),
    "k6_384threads": ("segsum.cu", (("constexpr int K6_THREADS = 128;", "constexpr int K6_THREADS = 384;"),)),
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
        src, subs, *base = VARIANTS[name]
        body = (base[0] if base else _build.CSRC / src).read_text()
        for text, repl in subs:
            if body.count(text) != 1:
                raise RuntimeError(f"variant {name}: {text!r} is not in {src} once")
            body = body.replace(text, repl)
        dirs[name] = source_dir(name, {src: body})
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
    """The side's library. `lib.k5_order` and `lib.k4_order` say whether
    its K5 and K4 take the order of their tiles (an argument after
    tile_count), `lib.k3_total` whether its K3 takes the instance total (an
    argument after num_tiles), `lib.k1_pair` and `lib.k2_pair` whether its
    K1 and K2 take the SH as two row sources (this tree's signatures) or
    as one tensor; `lib.k1_ld`, `lib.k2_acc` and `lib.bands` whether its
    K1 takes the table's row stride, its K2 the cotangents' row stride and
    the accumulate flag, and its K3, K4 and K5 the tile rows of a camera
    (the B-camera chain's arguments, the last before the stream)."""
    lib = ctypes.CDLL(str(path))
    lib.k5_order = "tile_order" in (src_dir / "blend_bwd.cu").read_text()
    lib.k4_order = "tile_order" in (src_dir / "blend_fwd.cu").read_text()
    lib.k3_total = "int total" in (src_dir / "expand.cu").read_text()
    lib.k1_pair = "sh_rest" in (src_dir / "preprocess_fwd.cu").read_text()
    lib.k2_pair = "sh_rest" in (src_dir / "preprocess_bwd.cu").read_text()
    lib.k1_ld = "int ld" in (src_dir / "preprocess_fwd.cu").read_text()
    lib.k2_acc = "cot_ld" in (src_dir / "preprocess_bwd.cu").read_text()
    lib.bands = {name: "gy_cam" in (src_dir / f"{name}.cu").read_text()
                 for name in ("expand", "blend_fwd", "blend_bwd")}
    for name in KERNELS.values():
        pair = {"preprocess_fwd": lib.k1_pair, "preprocess_bwd": lib.k2_pair}.get(name, True)
        argtypes = list(_build.SIGNATURES[name] if pair else ONE_TENSOR_SIGNATURES[name])
        if name == "blend_bwd" and not lib.k5_order:
            del argtypes[6]
        if name == "blend_fwd" and not lib.k4_order:
            del argtypes[5]
        if name == "expand" and not lib.k3_total:
            del argtypes[9]
        if name in lib.bands and not lib.bands[name]:
            del argtypes[-2]
        if name == "preprocess_fwd" and pair and not lib.k1_ld:
            del argtypes[-2]
        if name == "preprocess_bwd" and pair and not lib.k2_acc:
            del argtypes[-3:-1]
        fn = getattr(lib, f"gvd_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def calls(lib, k3_args, k5_args, k2_args, k6_grad, tile_count=None, fields=None):
    """({reading: closure}, {reading: outputs}): closures that launch
    `lib`'s K1 (`K1` and, with the SH pair, `K1s`), K3, K4, K5, K6 and K2
    on the arguments
    of tiling.expand_inputs and chip_smoke.bwd_inputs (K6 on the instance
    rows `k6_grad`), into outputs allocated here (K3's histogram zeroed in
    each call; K5's rows zeroed once: the kernel writes the rows it reaches
    and no other; K4's and K5's tiles in the order the binning gives them,
    or by `tile_count` in its place). `fields`: K4's table and owner ids in
    place of K1's table and the binning's."""
    tab, binning, color, depth, alpha, dC, dD, dA, w, h = k5_args
    k4_tab, k4_ids = fields or (tab, binning.inst_gauss)
    dev = tab.device
    counts = binning.tile_count if tile_count is None else tile_count
    order = binning.tile_order if tile_count is None else \
        torch.argsort(counts, descending=True, stable=True).to(torch.int32)
    _, rmx, rmy, rw, count, offsets, gx, num_tiles, total = k3_args
    keys = torch.empty((total,), dtype=torch.int64, device=dev)
    owners = torch.empty((total,), dtype=torch.int32, device=dev)
    hist = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    img = (torch.empty((3, h, w), device=dev), torch.empty((h, w), device=dev), torch.empty((h, w), device=dev))
    grad = torch.zeros((binning.num_instances, 10), device=dev)
    means, scales, rots, opac, sh, cam, sh_degree, sm, cot = k2_args
    f_dc, f_rest = sh if isinstance(sh, tuple) else (sh[:, :1].contiguous(), sh[:, 1:].contiguous())
    shs = torch.cat([f_dc, f_rest], 1)
    kt, n_all = shs.shape[1], means.shape[0]
    camc = preprocess_fused.cam_consts(cam)
    g = [torch.empty_like(t) for t in (means, scales, rots, opac)]
    g += [torch.empty_like(f_dc), torch.empty_like(f_rest)] if lib.k2_pair else [torch.empty_like(shs)]
    k1_out = {r: torch.empty((preprocess_fused.NUM_ROWS, n_all), device=dev) for r in ("K1", "K1s")}
    seg = torch.empty((10, n_all), device=dev)
    bg = torch.zeros(3, device=dev)
    stream = _build.stream_of(tab)
    n = tab.shape[1]

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")

    def k1(reading):
        out = k1_out[reading]
        if not lib.k1_pair:
            return check(lib.gvd_preprocess_fwd(means.data_ptr(), scales.data_ptr(), rots.data_ptr(),
                                                opac.data_ptr(), shs.data_ptr(), camc.data_ptr(),
                                                out.data_ptr(), n_all, kt, sh_degree, sh_degree, sm, w, h,
                                                stream), "K1")
        # K1 from one tensor: band 0 at shs, bands 1.. at shs + 3, rows of 3K
        dc, dcs, rest, rests = ((shs.data_ptr(), 3 * kt, shs.data_ptr() + 12, 3 * kt) if reading == "K1"
                                else (f_dc.data_ptr(), 3, f_rest.data_ptr(), 3 * (kt - 1)))
        check(lib.gvd_preprocess_fwd(means.data_ptr(), scales.data_ptr(), rots.data_ptr(), opac.data_ptr(),
                                     dc, dcs, rest, rests, camc.data_ptr(), None, out.data_ptr(), n_all,
                                     sh_degree, sh_degree, sm, w, h, int(reading == "K1s"),
                                     *([n_all] if lib.k1_ld else []), stream), "K1")

    def k3():
        hist.zero_()
        check(lib.gvd_expand(tab.data_ptr(), n, rmx.data_ptr(), rmy.data_ptr(), rw.data_ptr(), count.data_ptr(),
                             offsets.data_ptr(), gx, num_tiles, *([total] if lib.k3_total else []),
                             keys.data_ptr(), owners.data_ptr(), hist.data_ptr(),
                             *([num_tiles // gx] if lib.bands["expand"] else []), stream), "K3")

    def k4():
        check(lib.gvd_blend_fwd(k4_tab.data_ptr(), k4_tab.shape[1], k4_ids.data_ptr(), binning.tile_start.data_ptr(),
                                counts.data_ptr(), *([order.data_ptr()] if lib.k4_order else []), bg.data_ptr(),
                                binning.grid_x, binning.grid_y, w, h, *[t.data_ptr() for t in img],
                                *([binning.grid_y] if lib.bands["blend_fwd"] else []), stream), "K4")

    def k5():
        check(lib.gvd_blend_bwd(tab.data_ptr(), n, binning.inst_gauss.data_ptr(),
                                binning.perm.data_ptr(), binning.tile_start.data_ptr(), counts.data_ptr(),
                                *([order.data_ptr()] if lib.k5_order else []), color.data_ptr(), depth.data_ptr(),
                                alpha.data_ptr(), dC.data_ptr(), dD.data_ptr(), dA.data_ptr(), binning.grid_x,
                                binning.grid_y, w, h, grad.data_ptr(),
                                *([binning.grid_y] if lib.bands["blend_bwd"] else []), stream), "K5")

    def k6():
        check(lib.gvd_segsum(k6_grad.data_ptr(), binning.offsets.data_ptr(), binning.count.data_ptr(), n_all,
                             seg.data_ptr(), stream), "K6")

    def k2():
        sh_args = ([f_dc.data_ptr(), 3, f_rest.data_ptr(), 3 * (kt - 1)] if lib.k2_pair else [shs.data_ptr()])
        check(lib.gvd_preprocess_bwd(means.data_ptr(), scales.data_ptr(), rots.data_ptr(), *sh_args,
                                     camc.data_ptr(), cot.data_ptr(), n_all, kt, sh_degree,
                                     sh_degree, sm, cam.width, cam.height, *[t.data_ptr() for t in g],
                                     *([n_all, 0] if lib.k2_acc else []), stream), "K2")

    fns = {"K1": lambda: k1("K1"), "K1s": lambda: k1("K1s"), "K3": k3, "K4": k4, "K5": k5, "K6": k6, "K2": k2}
    outs = {"K1": (k1_out["K1"],), "K1s": (k1_out["K1s"],), "K3": (keys, owners, hist), "K4": img,
            "K5": (grad,), "K6": (seg,), "K2": g}
    if not lib.k1_pair:
        del fns["K1s"], outs["K1s"]
    return fns, outs


def k2_grads(outs):
    """K2's gradients with the SH gradient as one (N, K, 3) tensor."""
    return outs[:4] + [torch.cat(outs[4:], 1)] if len(outs) == 6 else outs


def equal_to_new(reading, outs, ref, binned):
    """Whether a side's outputs of one reading are bitwise "new"'s: `K1s`
    against "new"'s full table, every row but rows 6-8 of the Gaussians
    that no tile holds (`binned` False), which must be zero."""
    if reading == "K1s":
        tab, full = outs[0], ref["K1"][0]
        rgb = slice(preprocess_fused.F_R, preprocess_fused.F_D)
        keep = torch.ones_like(tab, dtype=torch.bool)
        keep[rgb] = binned
        return bool(torch.equal(tab[keep], full[keep]) and not tab[rgb][:, ~binned].any())
    if reading == "K2":
        return all(torch.equal(a, b) for a, b in zip(k2_grads(outs), k2_grads(ref[reading])))
    return all(torch.equal(a, b) for a, b in zip(outs, ref[reading]))


def k6_report(runs, k6_grad, binning, ref_after) -> dict:
    """For each side: its K6 sums within k6_tol of the float64 sums, and
    those of the Gaussians of at most one slot bitwise "old"'s; "new"'s
    sums after the timed launches bitwise its first ones; the Gaussians of
    two slots or more and their slots."""
    off, cnt = binning.offsets, binning.count
    exact = segsum.segment_sum_sorted_plain(k6_grad, off, cnt)
    tol = cnt.float()[None, :] * 2.0 ** -23 * segsum.segment_sum_sorted_plain(k6_grad.abs(), off, cnt) + 1e-30
    old = runs["old"][1]["K6"][0]
    short = cnt <= 1
    out = {side: dict(within_k6_tol=bool(((outs["K6"][0] - exact).abs() <= tol).all()),
                      one_slot_bitwise_old=bool(torch.equal(outs["K6"][0][:, short], old[:, short])))
           for side, (_, outs) in runs.items()}
    out["new"].update(run_to_run_bitwise=ref_after, multi_slot_gaussians=int((~short).sum()),
                      multi_slot_slots=int(cnt[~short].sum()))
    return out


def owner_spans(k3_args, window: int = 512) -> dict:
    """K3's slot windows on one view: the Gaussians in view, and over the
    windows of `window` slots the span of Gaussian indices from a window's
    first owner to the next window's (K3 scans a span below 2,048 and
    samples a longer one), and the longest run of Gaussians out of view."""
    count, total = k3_args[4].long(), k3_args[-1]
    ends = torch.cumsum(count, 0)
    starts = torch.arange(0, total, window, device=count.device)
    first = torch.searchsorted(ends, starts, right=True)
    nxt = torch.searchsorted(ends, torch.clamp(starts + window, max=total - 1), right=True)
    span = (nxt - first).float()
    seen = torch.nonzero(count > 0).flatten()
    edges = torch.cat([seen.new_tensor([-1]), seen, seen.new_tensor([count.numel()])])
    return dict(in_view=int(seen.numel()), windows=int(span.numel()), span_median=float(span.median()),
                spans_from_2048=int((span >= 2048).sum()), spans_from_8192=int((span >= 8192).sum()),
                span_max=int(span.max()), longest_run_out_of_view=int((torch.diff(edges) - 1).max()))


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
        lines = [ln for ln in cs.ptxas_summary(log)
                 if any(f"{name}_kernel" in ln for name in KERNELS.values())]
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
        k3_args = (tab, *tiling.expand_inputs(tab, preprocess_fused.visible_radii(tab), cs.WIDTH, cs.HEIGHT))
        blended, culled, walks = cs.evaluated_pairs(tab, binning, cs.WIDTH, cs.HEIGHT)
        binned = k3_args[4] > 0
        k6_grad = raster_tiles._run_bwd(*k5_args)
        runs = {side: calls(lib, k3_args, k5_args, k2_args, k6_grad) for side, lib in loaded.items()}
        for fns, _ in runs.values():
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
        ref = runs["new"][1]
        equal = {side: {k: equal_to_new(k, outs[k], ref, binned) for k in outs}
                 for side, (_, outs) in runs.items()}
        first_k6 = ref["K6"][0].clone()
        ms = {side: {k: [] for k in runs[side][0]} for side in sides}
        for side in turns:
            for k, fn in runs[side][0].items():
                ms[side][k].append(cs.event_ms(fn))
        k6 = k6_report(runs, k6_grad, binning, bool(torch.equal(ref["K6"][0], first_k6)))
        heavy = int(walks.argmax())
        alone = torch.zeros_like(binning.tile_count)
        alone[heavy] = binning.tile_count[heavy]
        tail_ms = {}
        for side, lib in loaded.items():
            fns = calls(lib, k3_args, k5_args, k2_args, k6_grad, tile_count=alone)[0]
            tail_ms[side] = {k: cs.event_ms(fns[k]) for k in ("K4", "K5")}
        without = {}
        for name, drop in (("longest", walks == walks.max()),
                           ("longest 1%", walks >= torch.quantile(walks.float(), 0.99))):
            counts = torch.where(drop.to(binning.tile_count.device), 0, binning.tile_count)
            without[name] = (int(drop.sum()), cs.event_ms(calls(loaded["new"], k3_args, k5_args, k2_args,
                                                                 k6_grad, tile_count=counts)[0]["K5"]))
        # K4 on a table gathered beforehand into instance order (rows of
        # M, owner i of instance i): its copies read consecutive addresses,
        # and its outputs stay bitwise the same
        m = binning.num_instances
        gathered_tab = torch.zeros((16, m), device=tab.device)
        gathered_tab[:10] = tab[:10, binning.inst_gauss.long()]
        fields = (gathered_tab, torch.arange(m, dtype=torch.int32, device=tab.device))
        gathered = {}
        for side in ("old", "new"):
            fns, outs = calls(loaded[side], k3_args, k5_args, k2_args, k6_grad, fields=fields)
            gathered[side] = (cs.event_ms(fns["K4"]), all(torch.equal(a, b) for a, b in zip(outs["K4"], ref["K4"])))
        del gathered_tab, fields
        k1b = cs.k1_bounds(k2_args[:5], int(binned.sum()))
        bounds = {"K1": k1b["all_rows"], "K1s": k1b["needed"], "K3": cs.k3_bound(k3_args),
                  "K4": cs.k4_bound(binning, cs.WIDTH, cs.HEIGHT, blended, culled),
                  "K5": cs.k5_bound(k5_args, blended, culled), "K6": cs.k6_bound(k6_grad, binning),
                  "K2": cs.k2_bound(k2_args)}
        stats = cs.tile_stats(binning, walks)
        spans = owner_spans(k3_args)
        result["views"][view] = dict(
            gaussians=tab.shape[1], binned=int(binned.sum()), instances=binning.num_instances, blended=blended,
            walked=blended + culled,
            tiles=stats, k3_windows=spans, bitwise_equal_to_new=equal, k6=k6, ms=ms, bounds=bounds,
            tail=dict(tile=heavy, tile_count=int(binning.tile_count[heavy]), walk=int(walks[heavy]),
                      ms=tail_ms, new_k5_without=without), k4_gathered_table=gathered)
        print(f"{view} ({tab.shape[1]} Gaussians, {int(binned.sum())} in a tile, "
              f"{binning.num_instances} instances, pairs walked "
              f"{blended + culled}, blended {blended}; {stats}; K3 windows {spans}): bitwise equal to new {equal} | "
              f"K6 {k6} | "
              f"CUDA events over {cs.EVENT_LAUNCHES} launches, turns {' '.join(turns)}: "
              + " | ".join(f"{side} " + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in ms[side][k])}"
                                                  for k in ms[side]) + " ms" for side in sides)
              + " | bounds " + ", ".join(f"{k} {b[0]:.4f} ms ({b[1]})" for k, b in bounds.items())
              + f" | on tile {heavy} alone (count {int(binning.tile_count[heavy])}, walk "
              f"{int(walks[heavy])}): " + ", ".join(f"{side} K4 {t['K4']:.4f} K5 {t['K5']:.4f} ms"
                                                    for side, t in tail_ms.items())
              + " | new K5 without " + ", ".join(f"the {name} ({n} tiles) {t:.4f} ms"
                                                 for name, (n, t) in without.items())
              + " | K4 on the table gathered into instance order: " + ", ".join(
                  f"{side} {t:.4f} ms (bitwise equal to new {eq})" for side, (t, eq) in gathered.items()),
              flush=True)
        del runs
    print(json.dumps(result))


if __name__ == "__main__":
    main()
