"""Device ms a DDIM step under the program's range "nn.attention"
(diffusion/nnops.py::attention and the relative-position form in
attention.py::_attend): L1 and the einsum attention, backward kernels
counted with their forward op."""

MOVES = "ddim_step_ms"
LABEL = "nn.attention"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
