"""Training metrics as JSON lines.

Counterpart of the JSONL part of `guidedvd3dgs_tpu/train/logging.py::
MetricsLogger`: scalars stream to `<model_path>/metrics.jsonl`, one JSON
object per line with the step and the wall time; a histogram is recorded
as its mean, min and max.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, model_path: str):
        self.path = os.path.join(model_path, "metrics.jsonl")
        os.makedirs(model_path, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

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

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
