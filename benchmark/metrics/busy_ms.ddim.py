"""Device ms a DDIM step: the union of the kernels' intervals in the traced
window over the steps traced. Steadier than the host's clock from run to
run (it leaves out the host's pace), so a kernel's gain shows here where
the end-to-end metric's spread hides it."""

MOVES = "ddim_step_ms"


def read(view):
    if view.busy_s <= 0:
        return None
    return view.busy_s / view.steps * 1e3
