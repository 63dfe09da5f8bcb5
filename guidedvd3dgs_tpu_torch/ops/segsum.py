"""Kernel K6: per-Gaussian sum of the per-instance gradients, and its plain
version.

Counterpart of `guidedvd3dgs_tpu/ops/segsum.py::segment_sum_sorted`. The
reference sorts the per-instance gradients by owner and sums each owner's
run; here no sort is needed: Gaussian g's instances own the contiguous
expansion slots [offsets[g], offsets[g] + count[g]) (K3's layout, kept in
ops/tiling.py::TileBinning), and the tile backward writes each instance's
10 gradients to its slot. The CUDA kernel is csrc/segsum.cu: one warp
sums a Gaussian's slots in a fixed order (lane l adds slots l, l + 32, ...
in order, then the 32 lane sums are added in lane order), the same bits in
every run; the plain version sums in float64.
"""

from __future__ import annotations

import torch

from guidedvd3dgs_tpu_torch.ops import _build

NF = 10


def segment_sum_sorted_plain(grad: torch.Tensor, offsets: torch.Tensor,
                             count: torch.Tensor) -> torch.Tensor:
    """Plain version of K6, loop-free: each slot's row added into its owner
    in float64 (`index_add_`), rounded to f32 once. Returns (10, N) f32.
    (A float64 prefix sum and its differences would lose a small sum that
    follows a large prefix.)"""
    n = offsets.shape[0]
    owner = torch.repeat_interleave(torch.arange(n, device=grad.device), count.long(),
                                    output_size=grad.shape[0])
    out = torch.zeros((n, grad.shape[1]), dtype=torch.float64, device=grad.device)
    out.index_add_(0, owner, grad.to(torch.float64))
    return out.to(torch.float32).t().contiguous()


def segment_sum_sorted(grad: torch.Tensor, offsets: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """grad: (M, 10) f32 per-instance gradients in expansion-slot order;
    offsets/count: (N,) int32 slot range of each Gaussian. Returns the
    (10, N) f32 per-Gaussian sums. CPU tensors take the plain version; CUDA
    tensors launch kernel K6."""
    if grad.device.type == "cpu":
        return segment_sum_sorted_plain(grad, offsets, count)
    if grad.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {grad.device}")
    dev = grad.device
    n = offsets.shape[0]
    _build.check_cuda("grad", grad, torch.float32, dev, (None, NF))
    _build.check_cuda("offsets", offsets, torch.int32, dev, (n,))
    _build.check_cuda("count", count, torch.int32, dev, (n,))
    if grad.data_ptr() % 8:
        raise ValueError("grad must start at an 8-byte boundary (its rows are read 8 bytes at a time)")
    out = torch.empty((NF, n), dtype=torch.float32, device=dev)
    _build.launch("segsum", grad.data_ptr(), offsets.data_ptr(), count.data_ptr(), n,
                  out.data_ptr(), _build.stream_of(grad))
    return out
