"""Reads of device values by the host a trainer step: the program's
counter "host.readbacks" (guidedvd3dgs_tpu_torch/utils/tracing.py) over the
traced steps. Each such read waits for every kernel queued before it, so
nothing is dispatched ahead across it. The counter counts only while a
profiler records, so it holds the traced steps alone."""

MOVES = "train_step_ms"
COUNTER = "host.readbacks"


def read(view):
    try:
        from guidedvd3dgs_tpu_torch.utils.tracing import COUNTS
    except ImportError:  # a program without the counter
        return None
    n = COUNTS.get(COUNTER)
    return None if not n else n / view.steps
