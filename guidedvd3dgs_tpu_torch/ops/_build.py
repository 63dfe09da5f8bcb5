"""Build, load and launch the port's CUDA kernels.

The sources in `guidedvd3dgs_tpu_torch/csrc/*.cu` are compiled by `nvcc`
into one shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so the build takes seconds). The library is built at
first use into `build/torch_kernels/` of the checkout, named by a hash of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code and only then
counts the launch in `LAUNCHES`, so a count says the kernel really ran.

Two threads may launch at once (the guided trainer's steps and a diffusion
event on its worker): the library is built and loaded once under a lock,
and the counts are kept under another. The one cache a kernel keeps, K2's
and K3's resident-block query per (kernel, device, smem)
(`csrc/common.cuh::resident_blocks`), holds its own mutex, and the runtime
keeps the error `cudaGetLastError()` reads per host thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # IEEE op by op, as the plain versions compute (see csrc/common.cuh)
    "-fmad=false",
    "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point (the trailing pointer is the stream)
SIGNATURES = {
    "preprocess_fwd": [_P] * 5 + [_I, _P, _I] + [_P] * 3 + [_I] * 3 + [_F, _I, _I, _I, _I, _P],
    "expand": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "blend_fwd": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "blend_bwd": [_P, _I] + [_P] * 11 + [_I] * 4 + [_P, _I, _P],
    "segsum": [_P, _P, _P, _I, _P, _P],
    "preprocess_bwd": [_P] * 4 + [_I, _P, _I, _P, _P] + [_I] * 4 + [_F, _I, _I] + [_P] * 6 + [_I, _I, _P],
    "flash_attn_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "flash_attn_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _P],
    "flash_attn_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _P],
}

# Launch counts of each kernel in this process; `launch` is the only writer.
LAUNCHES = {name: 0 for name in SIGNATURES}
_launch_lock = threading.Lock()

_lib = None  # the loaded library, once built
_lib_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgvd_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if the library for the current sources is
    missing: one nvcc per source, all started together, then one link.
    Returns (path, seconds spent compiling, compiler output: that of the
    build that made the library, if it was built before)."""
    path = library_path()
    if path.exists():
        log = path.with_suffix(".log")
        return path, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    tag = f"{path.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *compile_flags, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    objs = [obj for _, obj, _ in jobs]
    cmd = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = "".join(logs) + proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    # atomic: a concurrent build never loads a half-written library
    os.replace(tmp, path)
    path.with_suffix(".log").write_text(log)
    return path, secs, log


def library() -> ctypes.CDLL:
    """The loaded library, built on the first call; a second thread's first
    call waits for that build instead of starting its own."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, f"gvd_{name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gvd_error_string.argtypes = [ctypes.c_int]
            lib.gvd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call kernel entry `gvd_<name>` and raise if its launch failed."""
    lib = library()
    rc = getattr(lib, f"gvd_{name}")(*args)
    if rc != 0:
        msg = lib.gvd_error_string(rc).decode()
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc} ({msg})")
    with _launch_lock:
        LAUNCHES[name] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
               shape: tuple | None = None) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device` of
    `shape` (None entries match any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and (
        t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
