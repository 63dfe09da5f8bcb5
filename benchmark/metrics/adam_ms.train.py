"""Device ms a trainer step under the span around the program's Adam
(`models/gaussians.py::adam_step`)."""

MOVES = "train_step_ms"
SPANS = [("guidedvd3dgs_tpu_torch.models.gaussians", "adam_step", "adam")]


def read(view):
    s = view.label_s.get("adam")
    return None if not s else s / view.steps * 1e3
