"""Training metrics as JSON lines, and the profiler's trace window.

Counterpart of `guidedvd3dgs_tpu/train/logging.py`: scalars stream to
`<model_path>/metrics.jsonl`, one JSON object per line with the step and
the wall time; a histogram is recorded as its mean, min and max; images
as a record of the event, and into TensorBoard (`<model_path>/tb`) where
`torch.utils.tensorboard` imports (imported at the first image, since it
takes seconds). `maybe_profiler_trace` is the trainers' `--profile_dir`
window under torch.profiler.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class MetricsLogger:
    def __init__(self, model_path: str):
        self.path = os.path.join(model_path, "metrics.jsonl")
        os.makedirs(model_path, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._model_path = model_path
        self._tb = None  # the TensorBoard writer, made at the first image

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[f"{prefix}{k}"] = float(v)
        self._f.write(json.dumps(rec) + "\n")

    def histogram(self, step: int, name: str, values) -> None:
        arr = np.asarray(values).ravel()
        self._f.write(
            json.dumps(
                {
                    "step": int(step),
                    f"{name}/mean": float(arr.mean()) if arr.size else 0.0,
                    f"{name}/min": float(arr.min()) if arr.size else 0.0,
                    f"{name}/max": float(arr.max()) if arr.size else 0.0,
                }
            )
            + "\n"
        )

    def images(self, step: int, name: str, images) -> None:
        """images: (N, 3, H, W) in [0, 1]. TensorBoard receives them where
        it imports; the JSON lines record the event."""
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._tb = False
            else:
                self._tb = SummaryWriter(os.path.join(self._model_path, "tb"))
        if self._tb:
            arr = np.clip(np.asarray(images.detach().cpu() if torch.is_tensor(images) else images), 0.0, 1.0)
            self._tb.add_images(name, arr, int(step))
        self._f.write(json.dumps({"step": int(step), "images": name}) + "\n")

    def close(self) -> None:
        self._f.close()
        if self._tb:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_profiler_trace(profile_dir: Optional[str], start: bool,
                         prof: Optional[torch.profiler.profile] = None) -> Optional[torch.profiler.profile]:
    """torch.profiler's trace window (JAX logging.py:73-83, which runs
    jax.profiler): with `start`, a started profiler of the CPU and, where
    the host has one, CUDA activities; else `prof` stopped and its Chrome
    trace written as `<profile_dir>/trace.json`. Nothing without a
    profile_dir. Returns the running profiler, or None."""
    if not profile_dir:
        return None
    if start:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return None
