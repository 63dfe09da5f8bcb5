"""The least times of the six Gaussian kernels and of a trainer step's
other counted work, from counts the benchmark works out itself (the plain
reference's binning of the traced state: benchmark/reference/gs/raster.py
`Counts`), never from the program's counters.

The per-kernel byte and operation counts are frozen copies of
`chip_smoke.py::k1_bounds` (`needed`), `k3_bound`, `k4_bound`, `k5_bound`,
`k6_bound` and `k2_bound`; all f32, at the published peaks (counts/peaks.py).
"""

from __future__ import annotations

from counts.peaks import bound_s

# f32 operations per (instance, pixel) pair a pixel walks before its stop:
# every walked pair the offset and the quadratic form (11); a blended pair
# in K4 also exp, alpha, T and the 5 accumulations (26 in all); in K5 that
# and u, the prefix and suffix sums, dalpha, the 10 values and their sums
# over the tile's pixels (56 in all)
WALKED_FLOPS = 11
K4_BLENDED_FLOPS = 26
K5_BLENDED_FLOPS = 56
SH_COEFFS = 16  # degree 3
PARAM_FLOATS = 3 + 3 * SH_COEFFS + 3 + 4 + 1  # xyz, SH, scaling, rotation, opacity a Gaussian


def k1_s(c) -> float:
    """geometry (44 B) read and 16 rows (64 B) written a Gaussian, the SH
    (192 B) of the binned ones; ~600 operations a Gaussian."""
    return bound_s(c.gaussians * (11 * 4 + 16 * 4) + c.binned * SH_COEFFS * 3 * 4, 600 * c.gaussians)


def k3_s(c) -> float:
    """the count read for every Gaussian, 11 more rows for those in view, 12
    B an instance and the histogram written; ~60 operations an instance."""
    return bound_s(c.gaussians * 4 + c.binned * 11 * 4 + c.instances * 12 + c.tiles * 4, 60 * c.instances)


def k4_s(c) -> float:
    return bound_s(c.instances * 44 + c.tiles * 12 + c.pixels * 20,
                   K4_BLENDED_FLOPS * c.blended + WALKED_FLOPS * c.walked)


def k5_s(c) -> float:
    return bound_s(c.instances * 48 + c.tiles * 8 + c.pixels * 40 + c.instances * 40,
                   K5_BLENDED_FLOPS * c.blended + WALKED_FLOPS * c.walked)


def k6_s(c) -> float:
    return bound_s(c.instances * 40 + c.gaussians * 48, c.instances * 10)


def k2_s(c) -> float:
    """the inputs read and their gradients written, 10 cotangents read;
    ~1000 operations a Gaussian."""
    n_in = c.gaussians * PARAM_FLOATS * 4
    return bound_s(2 * n_in + 10 * 4 * c.gaussians, 1000 * c.gaussians)


def chain(counts):
    """The counts of a chain of views rendered as one binning: K3-K6 see
    their instances, tiles, pixels and pairs together, the Gaussians once."""
    first = counts[0]
    return type(first)(first.gaussians, *(sum(getattr(c, f) for c in counts) for f in first._fields[1:]))


def train_kernels_s(counts) -> float:
    """The six kernels of one trainer step over its views (one chain): K1
    and K2 once a view, K3-K6 once over the chain."""
    c = chain(counts)
    return sum(k1_s(v) + k2_s(v) for v in counts) + k3_s(c) + k4_s(c) + k5_s(c) + k6_s(c)


def adam_s(n_gaussians: int) -> float:
    """Adam reads each parameter, its gradient and two moments and writes
    the parameter and both moments: 7 f32 an element."""
    return bound_s(7 * 4 * PARAM_FLOATS * n_gaussians, 0)


def loss_s(counts) -> float:
    """L1 (+ SSIM) of each view: the render and the ground truth read, the
    image's gradient written: 3 f32 a pixel and channel."""
    return bound_s(sum(3 * 4 * 3 * c.pixels for c in counts), 0)
