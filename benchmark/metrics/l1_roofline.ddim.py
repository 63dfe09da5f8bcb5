"""Kernel L1's share of its roofline in a DDIM step: the least time of
every L1 launch of a step (benchmark/counts/attention.py, from the
configuration's shapes) over the device time of the kernels named
flash_attn in the traced steps, per step."""

from counts.attention import step_least_s

MOVES = "ddim_step_ms"


def read(view):
    dev_s = view.kernels("flash_attn") / view.steps
    least = step_least_s(view.info["cfg"], view.info["traffic"])
    if dev_s <= 0 or least <= 0:
        return None
    return 100.0 * least / dev_s
