"""Device ms a guided trainer step under the span around its VGG pseudo
term (`utils/vgg_loss.py::vgg_perceptual_loss`), backward kernels
included."""

MOVES = "train_step_ms"
SPANS = [("guidedvd3dgs_tpu_torch.utils.vgg_loss", "vgg_perceptual_loss", "vgg")]


def read(view):
    s = view.label_s.get("vgg")
    return None if not s else s / view.steps * 1e3
