"""Device ms a guided DDIM step under the program's range
"ddim.decode_grads" (ddim_guidance.py::per_frame_guidance_grads): the
guidance loss's gradients through the VAE decode, backward kernels included."""

MOVES = "ddim_step_ms"
LABEL = "ddim.decode_grads"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
