"""The whole trainer step's share of the card's peaks: the least time of
the traced steps' counted work over the host-clock time of as many steps
of the untraced stretch that runs just before them. The counted work is
the six Gaussian kernels' (benchmark/counts/gaussian.py, from the plain
reference's binning of each step's view), Adam's bytes on every step
without a densification, and the loss's bytes, at the published peaks. It
is counted from the inputs, so it still bounds a gain after a kernel is
fused away."""

from counts.gaussian import adam_s, loss_s, train_kernels_s

MOVES = "train_step_ms"


def read(view):
    if view.busy_s <= 0 or not view.step_s:
        return None
    counts = view.info["counts"]()
    least = 0.0
    for keys in view.info["views"][: view.steps]:
        cs = [counts[k] for k in keys]
        least += train_kernels_s(cs) + adam_s(cs[0].gaussians) + loss_s(cs)
    return 100.0 * least / (view.step_s * view.steps)
