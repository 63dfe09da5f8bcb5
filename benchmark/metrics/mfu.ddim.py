"""The whole DDIM step's share of the card's bf16 peak: the step's model
FLOPs (benchmark/counts/flops.py, counted over the plain reference on the
meta device) over 989 TFLOP/s times the host-clock time a step of the
untraced stretch that runs just before the traced steps."""

from counts.peaks import PEAK_BF16_FLOPS

MOVES = "ddim_step_ms"


def read(view):
    if view.busy_s <= 0 or not view.step_s:  # nothing ran on a device, or no untraced stretch
        return None
    step_s = view.step_s
    flops = view.info["flops"]()
    if step_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (PEAK_BF16_FLOPS * step_s)
