"""Device ms a DDIM step under the program's range "ddim.pair_forward": the
CFG pair's UNet forward (diffusion/samplers/ddim_guidance.py::pair_forward,
and the two UNet applications of ddim.py::cfg_model_output)."""

MOVES = "ddim_step_ms"
LABEL = "ddim.pair_forward"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
