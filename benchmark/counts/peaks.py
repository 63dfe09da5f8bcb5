"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time of a piece of work: the larger of
its bytes over the memory rate and its operations over the peak of their
type. A frozen copy of `chip_smoke.py::bound` and its `PEAK_*`."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def bound_s(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    """Seconds at the least: max(bytes / memory rate, operations / peak)."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops)
