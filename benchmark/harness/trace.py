"""Spans from the benchmark's own files, a profiler trace of part of the
window, and what the per-layer metrics read from it.

Spans are `record_function` ranges named "span:<label>" that `spans()`
puts around calls into the program's layers by patching the functions by
name (the program has no spans of its own yet). Each per-layer metric
file declares the spans it reads, `SPANS = [(module path, function name,
label), ...]`, naming every module that binds the function; a driver
sets the spans of the cell's metrics (`metric_spans`). A kernel counts
toward a label when the op that launched it lies inside such a range, or,
in a backward pass (which runs on autograd's thread), when the forward op whose
autograd node it runs did: the profiler's sequence number and forward
thread pair the two, as torch's own backward stack traces do.

`TraceView` is what a metric's `read(view)` gets: the traced window's
length and busy time, each label's device time, the kernels by name, the
number of steps traced, the host-clock time a step of the untraced
stretch that runs just before the traced steps (the profiler's own host cost
slows the traced ones), and `info`, the driver's counts for the traced
steps (shapes, Gaussians, instances).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple
from unittest import mock

import torch

SPAN = "span:"
WINDOW = "bench:window"


@contextlib.contextmanager
def spans(targets: Iterable[Tuple[object, str, str]]):
    """Patch each (module, function name, label) so that every call runs
    inside the range "span:<label>"."""
    with contextlib.ExitStack() as stack:
        for module, name, label in targets:
            fn = getattr(module, name)

            def run(*args, _fn=fn, _label=SPAN + label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _fn(*args, **kwargs)

            stack.enter_context(mock.patch.object(module, name, run))
        yield


def metric_spans(metrics) -> List[Tuple[object, str, str]]:
    """The (module, function name, label) targets that the per-layer
    metrics' files declare in `SPANS`, each once."""
    seen, out = set(), []
    for m in metrics:
        for mod_name, fn, label in getattr(m.reader, "SPANS", ()):
            if (mod_name, fn, label) not in seen:
                seen.add((mod_name, fn, label))
                out.append((importlib.import_module(mod_name), fn, label))
    return out


def note(what: str, seconds: float) -> None:
    """A traced run's time in one of its phases, on standard error."""
    print(f"trace: {what} {seconds:.2f} s", file=sys.stderr, flush=True)


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


@dataclass
class TraceView:
    steps: int
    window_s: float
    busy_s: float
    label_s: Dict[str, float]  # device seconds under each label
    label_host_s: Dict[str, float]  # host seconds inside each label's ranges (main thread)
    kernel_s: Dict[str, float]  # device seconds by kernel name
    kernel_count: Dict[str, int]
    gaps: List[Tuple[str, float]]  # idle gaps of the window by what the host was doing
    step_s: Optional[float] = None  # host seconds a step of the untraced stretch
    info: dict = field(default_factory=dict)

    def kernels(self, *pieces: str) -> float:
        """Device seconds of the kernels whose name holds any piece."""
        return sum(s for k, s in self.kernel_s.items() if any(p in k for p in pieces))

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def _labels(evt) -> frozenset:
    out = set()
    while evt is not None:
        if evt.name.startswith(SPAN):
            out.add(evt.name[len(SPAN):])
        evt = evt.cpu_parent
    return frozenset(out)


def _backward_node(evt):
    while evt is not None:
        if evt.scope == 1:  # a backward function
            return evt
        evt = evt.cpu_parent
    return None


def _union(intervals) -> List[Tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(prof, steps: int, info: Optional[dict] = None, step_s: Optional[float] = None) -> TraceView:
    events = prof.events()
    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0 = min(e.time_range.start for e in window)
    w1 = max(e.time_range.end for e in window)
    fwd: Dict[tuple, frozenset] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.sequence_nr >= 0 and _backward_node(e) is None:
            lab = _labels(e)
            if lab:
                fwd.setdefault((e.sequence_nr, e.thread), lab)
    kernels, label_us, host_us, k_us, k_n = [], {}, {}, {}, {}
    host_ops = []
    main_thread = window[0].thread
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name == WINDOW or e.name.startswith(SPAN):
                continue  # a range of ours, mirrored on the device's timeline
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                kernels.append((s, t))
                k_us[e.name] = k_us.get(e.name, 0.0) + (t - s)
                k_n[e.name] = k_n.get(e.name, 0) + 1
            continue
        if e.name.startswith(SPAN) and e.thread == main_thread:
            lab = e.name[len(SPAN):]
            host_us[lab] = host_us.get(lab, 0.0) + (e.time_range.end - e.time_range.start)
        if e.thread == main_thread and e.cpu_parent is not None and e.cpu_parent.name == WINDOW:
            host_ops.append(e)
        if not e.kernels:
            continue
        lab = _labels(e)
        node = _backward_node(e)
        if node is not None:
            lab = lab | fwd.get((node.sequence_nr, node.fwd_thread), frozenset())
        for k in e.kernels:
            for name in lab:
                label_us[name] = label_us.get(name, 0.0) + k.duration
    busy = _union(kernels)
    busy_us = sum(t - s for s, t in busy)
    # idle gaps: the stretches of the window without a kernel, each named by
    # the outermost host op that covers its middle (the window's direct
    # children follow each other, so a bisection over their starts finds it)
    gaps, prev, cache = {}, w0, {}
    hosts = sorted(((h.time_range.start, h.time_range.end, h) for h in host_ops), key=lambda x: x[0])
    starts = [h[0] for h in hosts]
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            mid = 0.5 * (s + prev)
            name = "host: between ops"
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and hosts[i][1] >= mid:
                name = _deepest(hosts[i][2], mid, cache)
            gaps[name] = gaps.get(name, 0.0) + (s - prev) / 1e6
        prev = max(prev, t)
    return TraceView(
        steps=steps, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        label_s={k: v / 1e6 for k, v in label_us.items()},
        label_host_s={k: v / 1e6 for k, v in host_us.items()},
        kernel_s={k: v / 1e6 for k, v in k_us.items()}, kernel_count=k_n,
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]), step_s=step_s, info=dict(info or {}))


def _deepest(evt, t: float, cache: Optional[dict] = None) -> str:
    """The innermost span, else the innermost op, that covers time t. Each
    op's children, in order of their starts, are kept in `cache`, so that a
    gap's op is found by bisection."""
    cache = {} if cache is None else cache
    best, span = evt, None
    while True:
        if best.name.startswith(SPAN):
            span = best
        key = id(best)
        if key not in cache:
            kids = sorted(best.cpu_children, key=lambda c: c.time_range.start)
            cache[key] = ([c.time_range.start for c in kids], kids)
        starts, kids = cache[key]
        i = bisect.bisect_right(starts, t) - 1
        # children may nest in time only through their own children, so the
        # last one to start by t is the only one that can cover it
        if i < 0 or kids[i].time_range.end < t:
            break
        best = kids[i]
    if span is not None and span is not best:
        return f"{span.name} > {best.name}"
    return best.name
