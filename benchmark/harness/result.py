"""The run's last line and the numbers that decided `correct`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number compared, with its limit.
The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # a NaN reading fails
        return self.value <= self.limit


def device_info(dev, count: int, peak_bytes: int, busy_s: Optional[float] = None,
                window_s: Optional[float] = None) -> dict:
    import torch

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        info["busy_s"] = busy_s
        info["window_s"] = window_s
    return info


def line(checks: Dict[str, Check], attempted: int, failed: int, metrics: dict, device: dict,
         breakdown: Optional[dict] = None, extra: Optional[dict] = None) -> dict:
    """`extra`: further keys of the run's own (the driver ignores them)."""
    out = {"correct": bool(checks) and all(c.ok for c in checks.values()) and failed == 0,
           "attempted": int(attempted), "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in checks.items()}
    return out


def emit(out: dict) -> None:
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
