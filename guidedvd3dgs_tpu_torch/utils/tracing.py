"""Named ranges and counters at the program's layer boundaries.

`span(label)` is a range named "span:<label>" while a profiler records
(`torch.autograd._profiler_enabled()`), else one shared null context: with
nothing recording, a range costs one boolean check. The range is torch's
`_RecordFunctionFast`, the form of `torch.profiler.record_function` made in
C++ (the same range at about a tenth of its host cost under the profiler,
so a traced step keeps its pace), where the installed torch has it. The
ranges lie on the profiler's timeline beside the CUDA kernels, so a trace
can put each kernel, and each stretch in which the card waits for the
host, under the innermost range of the program that covers it.
Labels are `<layer>.<part>` (`train.render`, `ddim.pair_vjp`, `nn.conv`).

`span(label, into=d, key=k)` also adds the range's host seconds to `d[k]`,
whether or not a profiler records (the guided trainer's event timers).

`count(name, n)` adds to `COUNTS[name]` only while a profiler records, so a
process that profiles one stretch counts that stretch; `reset()` clears the
counts. `readback(n)` is the range of `n` places on a step's path where the
host waits for the card, counted under "host.readbacks".
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

PREFIX = "span:"
COUNTS: Dict[str, int] = {}
_NULL = contextlib.nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
recording = torch.autograd._profiler_enabled


class _Timed:
    """A span that also adds its host seconds to `into[key]`."""

    __slots__ = ("label", "into", "key", "t0", "range")

    def __init__(self, label: str, into: dict, key: str):
        self.label, self.into, self.key = label, into, key

    def __enter__(self):
        self.range = span(self.label)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.into[self.key] = self.into.get(self.key, 0.0) + (time.perf_counter() - self.t0)
        return self.range.__exit__(*exc)


def span(label: str, into: Optional[dict] = None, key: Optional[str] = None):
    """The range "span:<label>" while a profiler records (module docstring);
    with `into`, also timed into `into[key]` (default: the label)."""
    if into is not None:
        return _Timed(label, into, label if key is None else key)
    if recording():
        return _RANGE(PREFIX + label)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """COUNTS[name] += n while a profiler records."""
    if recording():
        COUNTS[name] = COUNTS.get(name, 0) + int(n)


def reset() -> None:
    COUNTS.clear()


def readback(n: int = 1):
    """The range "span:host.readback" around `n` places where the host waits
    for every kernel queued before them: a read of a device value, or a
    copy of pageable host memory to the card (torch synchronizes the stream
    for it). Counted under "host.readbacks"."""
    count("host.readbacks", n)
    return span("host.readback")
