"""The six Gaussian kernels' share of their roofline in the traced trainer
steps: the sum of their least times (benchmark/counts/gaussian.py, from the
plain reference's binning of each step's view at the window's initial
Gaussians) over the device time of the kernels K1-K6 by name."""

from counts.gaussian import train_kernels_s

MOVES = "train_step_ms"
KERNELS = ("preprocess_fwd_kernel", "preprocess_bwd_kernel", "expand_kernel", "blend_fwd_kernel",
           "blend_bwd_kernel", "segsum_kernel")


def read(view):
    dev_s = view.kernels(*KERNELS)
    if dev_s <= 0:
        return None
    counts = view.info["counts"]()
    least = sum(train_kernels_s([counts[k] for k in keys]) for keys in view.info["views"][: view.steps])
    return 100.0 * least / dev_s
