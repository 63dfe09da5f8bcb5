"""The share of the card's time in which no kernel runs, over trainer steps:
one minus the device time a step (the union of the kernels' intervals in
the traced steps, over the steps traced) over the host-clock time a step
of the untraced stretch that runs just before them. The traced steps'
own window is not the denominator: the profiler's host cost slows them
and widens their gaps."""

MOVES = "train_step_ms"


def read(view):
    if view.busy_s <= 0 or not view.step_s:  # nothing ran on a device, or no untraced stretch
        return None
    return 100.0 * (1.0 - view.busy_s / view.steps / view.step_s)
