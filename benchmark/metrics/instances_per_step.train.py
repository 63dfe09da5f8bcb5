"""Millions of (Gaussian, tile) instances the rasterizer binned a trainer
step: the program's counter "raster.instances" (the total that
ops/tiling.py::expand_inputs reads back once a chain) over the traced
steps. The counter counts only while a profiler records, so it holds the
traced steps alone."""

MOVES = "train_step_ms"
COUNTER = "raster.instances"


def read(view):
    try:
        from guidedvd3dgs_tpu_torch.utils.tracing import COUNTS
    except ImportError:  # a program without the counter
        return None
    n = COUNTS.get(COUNTER)
    return None if not n else n / view.steps / 1e6
