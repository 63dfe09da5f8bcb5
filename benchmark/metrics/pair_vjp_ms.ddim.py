"""Device ms a guided DDIM step under the program's range "ddim.pair_vjp"
(ddim_guidance.py::pair_vjp): each branch's UNet forward again and its VJP,
backward kernels (L1's among them) included."""

MOVES = "ddim_step_ms"
LABEL = "ddim.pair_vjp"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
