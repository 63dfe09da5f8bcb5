"""Device ms a DDIM step under the program's range "nn.conv"
(diffusion/nnops.py::conv2d, conv3d: every convolution of the UNet and the
VAE), backward kernels counted with their forward op."""

MOVES = "ddim_step_ms"
LABEL = "nn.conv"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
