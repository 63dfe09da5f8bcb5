"""Pipelined diffusion events (`pipeline_guidance`), port against the JAX
package on the CPU (the port's two ways of running them, its checkpoint,
its snapshot and the CLI: tests/test_torch_pipeline_worker.py).

- The JAX trainer with `pipeline_guidance = True` and the port's with its
  worker thread, on the scene of tests/test_torch_guided_densify.py (three
  40x40 views, a 96-point anisotropic start, the mock engine at 5 frames,
  SH degree 0), through iterations 1-15: boundaries at 1 (submit only), 8
  and 15 (finalize, then submit), densify events at 5 and 10, an opacity
  reset at 12, then the drain. After each step both count the same events
  and hold pseudo stacks of the same lengths, and each step's loss and
  pseudo_l1 agree within 1e-4; after each densify event and at the end the
  counts are equal and every parameter is within 1e-4 of its largest
  magnitude (the tolerances of tests/test_torch_train_guided.py).
- The kernel library and its launch counts from many threads at once, and
  the stream-local `_sync`.
"""

import sys
import threading

import numpy as np
import torch

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.train import guided as pg

from test_torch_guided_densify import _check_params, _trainers
from test_torch_train_guided import _np

torch.set_num_threads(2)

LAST = 15
BOUNDARIES = (1, 8, 15)  # guidance_vd_iter 7
DENSIFY_AT = (5, 10)


def _pipelined(*trainers, training_gs=False):
    """The trainers pipelined, with events every 7 steps."""
    for t in trainers:
        t.opt.guidance_vd_iter = 7
        t.pipeline_guidance = True
        if training_gs:
            t.opt.guidance_with_training_gs = True
            t.opt.guidance_with_training_gs_startiter = 0
    return trainers


def test_pipelined_events_match_reference_across_boundaries_a_densify_event_and_the_drain():
    jt, pt = _pipelined(*_trainers())
    for it in range(1, LAST + 1):
        js, ps = jt.step(it), pt.step(it)
        assert pt.events_run == jt.events_run, (it, pt.events_run, jt.events_run)
        assert (pt._pending_event is None) == (jt._pending_event is None), it
        assert len(pt.pseudo_stack) == len(jt.pseudo_stack), it
        assert len(pt.pseudo_stack_alltime) == len(jt.pseudo_stack_alltime), it
        assert ps.num_active == js.num_active, (it, ps.num_active, js.num_active)
        assert abs(float(ps.loss) - js.loss) <= 1e-4, (it, float(ps.loss), js.loss)
        jp, pp = float(jt.last_metrics["pseudo_l1"]), float(pt.last_metrics["pseudo_l1"])
        assert abs(pp - jp) <= 1e-4, (it, pp, jp)
        if it in DENSIFY_AT:
            _check_params(jt, pt, f"after the densify event at {it}")
    # the stack appears one boundary late: empty until the finalize at 8
    assert jt.events_run == pt.events_run == len(BOUNDARIES) - 1
    jt.finalize_diffusion_event(jt._pending_event)
    jt._pending_event = None
    pt.close_event_worker()
    assert pt._pending_event is None and pt._executor is None
    assert pt.events_run == jt.events_run == len(BOUNDARIES)
    assert len(pt.pseudo_stack) == len(jt.pseudo_stack) == 4
    assert len(pt.pseudo_stack_alltime) == len(jt.pseudo_stack_alltime)
    for g, w in zip(pt.pseudo_stack, jt.pseudo_stack):
        # the poses of a pool trajectory: float32 rounding apart
        np.testing.assert_allclose(g.world_view_transform, w.world_view_transform, atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(g.pseudo_gt), _np(w.pseudo_gt), atol=2e-5, rtol=1e-4)
    _check_params(jt, pt, "at the end")
    assert pt.event_wait_s >= 0.0


def test_two_threads_launching_together_count_exactly(monkeypatch):
    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "_lib", FakeLib())
    _build.reset_launches()
    threads, per = 8, 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [_build.launch("segsum") for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    assert _build.LAUNCHES["segsum"] == threads * per
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())


def test_the_library_is_built_once_when_threads_ask_for_it_together(monkeypatch, tmp_path):
    builds = []
    started = threading.Barrier(6)

    def fake_build():
        builds.append(threading.get_ident())
        return tmp_path / "lib.so", 0.0, ""

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    got = []

    def first_call():
        started.wait(timeout=30)
        got.append(_build.library())

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=first_call) for _ in range(6)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    assert len(builds) == 1 and len(got) == 6 and all(lib is got[0] for lib in got)


def test_sync_waits_on_the_calling_streams_work_only(monkeypatch):
    calls = []

    class FakeStream:
        def synchronize(self):
            calls.append("stream")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append("device"))
    pg._sync(torch.device("cuda", 0))
    pg._sync(torch.device("cpu"))
    assert calls == ["stream"]
