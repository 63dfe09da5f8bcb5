"""Device ms a trainer step under the program's range "train.loss": L1 and
SSIM of the train view and, guided, the pseudo view's terms with the VGG
term, backward kernels counted with their forward op."""

MOVES = "train_step_ms"
LABEL = "train.loss"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
