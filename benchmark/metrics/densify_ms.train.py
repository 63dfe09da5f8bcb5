"""Host ms a trainer step inside the span around the program's
densification (`models/gaussians.py::densify_and_prune`), over the traced
steps: the event's wall time, which holds its device work because it reads
counts back, spread over the steps between events."""

MOVES = "train_step_ms"
SPANS = [("guidedvd3dgs_tpu_torch.models.gaussians", "densify_and_prune", "densify")]


def read(view):
    s = view.label_host_s.get("densify")
    return None if not s else s / view.steps * 1e3
