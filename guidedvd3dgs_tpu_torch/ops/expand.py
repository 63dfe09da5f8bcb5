"""Kernel K3: instance expansion and its plain version.

Counterpart of `guidedvd3dgs_tpu/ops/expand.py::expand_instances`. Given
each Gaussian's tile rectangle, instance count and exclusive offset, it
writes for every (Gaussian, tile) instance the 64-bit sort key
`tile << 32 | f32 depth bits` and the owner id, and returns the per-tile
instance histogram. An instance whose maximum alpha over its tile is
provably below 1/255 (the reference kernel's conservative tile cull) keys
to the past-the-end tile `num_tiles` and is left out of the histogram.

The CUDA kernel is csrc/expand.cu.
"""

from __future__ import annotations

import torch

from guidedvd3dgs_tpu_torch.ops import _build
from guidedvd3dgs_tpu_torch.ops.preprocess_fused import F_CA, F_CB, F_CC, F_D, F_MX, F_MY, F_OP


def expand_instances_plain(
    tab: torch.Tensor,
    rect_min_x: torch.Tensor,
    rect_min_y: torch.Tensor,
    rect_w: torch.Tensor,
    count: torch.Tensor,
    offsets: torch.Tensor,
    gx: int,
    num_tiles: int,
    total: int,
):
    """Plain PyTorch version of K3: `repeat_interleave` and index
    arithmetic. Returns (keys (total,) int64, owners (total,) int32,
    hist (num_tiles,) int32)."""
    dev = tab.device
    n = tab.shape[1]
    owners = torch.repeat_interleave(
        torch.arange(n, device=dev, dtype=torch.int32), count.long(), output_size=total
    )
    gid = owners.long()
    s = torch.arange(total, device=dev, dtype=torch.int32) - offsets[gid]
    w = rect_w[gid]
    q = torch.div(s, w, rounding_mode="floor")
    rem = s - q * w
    tx = rect_min_x[gid] + rem
    ty = rect_min_y[gid] + q
    tile = ty * gx + tx

    mx, my = tab[F_MX][gid], tab[F_MY][gid]
    ca, cb, cc = tab[F_CA][gid], tab[F_CB][gid], tab[F_CC][gid]
    op = tab[F_OP][gid]
    ex0 = tx.float() * 16.0 - mx
    ex1 = ex0 + 15.0
    ey0 = ty.float() * 16.0 - my
    ey1 = ey0 + 15.0
    inside = (ex0 <= 0.0) & (0.0 <= ex1) & (ey0 <= 0.0) & (0.0 <= ey1)
    caf = torch.clamp(ca, min=1e-12)
    ccf = torch.clamp(cc, min=1e-12)

    def qv(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    qe0 = qv(ex0, torch.clamp(-cb * ex0 / ccf, ey0, ey1))
    qe1 = qv(ex1, torch.clamp(-cb * ex1 / ccf, ey0, ey1))
    qe2 = qv(torch.clamp(-cb * ey0 / caf, ex0, ex1), ey0)
    qe3 = qv(torch.clamp(-cb * ey1 / caf, ex0, ex1), ey1)
    minq = torch.minimum(torch.minimum(qe0, qe1), torch.minimum(qe2, qe3))
    minq = torch.where(inside, torch.zeros_like(minq), minq)
    cull = minq > torch.log(torch.clamp(op, min=1e-12) * 255.0)

    dbits = tab[F_D][gid].view(torch.int32).long() & 0xFFFFFFFF
    tile_key = torch.where(cull, torch.full_like(tile, num_tiles), tile)
    keys = (tile_key.long() << 32) | dbits
    hist = torch.bincount(tile[~cull].long(), minlength=num_tiles).to(torch.int32)
    return keys, owners, hist


def expand_instances(
    tab: torch.Tensor,
    rect_min_x: torch.Tensor,
    rect_min_y: torch.Tensor,
    rect_w: torch.Tensor,
    count: torch.Tensor,
    offsets: torch.Tensor,
    gx: int,
    num_tiles: int,
    total: int,
):
    """tab: the (16, N) K1 table; rect_min_x/rect_min_y/rect_w/count/
    offsets: (N,) int32, `count` instances of Gaussian g start at
    offsets[g]; total: sum of count. CPU tensors take the plain version;
    CUDA tensors launch kernel K3."""
    if tab.device.type == "cpu":
        return expand_instances_plain(
            tab, rect_min_x, rect_min_y, rect_w, count, offsets, gx, num_tiles, total
        )
    if tab.device.type != "cuda":
        raise ValueError(f"no expand kernel for device {tab.device}")
    dev = tab.device
    n = tab.shape[1]
    _build.check_cuda("tab", tab, torch.float32, dev, (16, n))
    for name, t in (("rect_min_x", rect_min_x), ("rect_min_y", rect_min_y),
                    ("rect_w", rect_w), ("count", count), ("offsets", offsets)):
        _build.check_cuda(name, t, torch.int32, dev, (n,))
    keys = torch.empty((total,), dtype=torch.int64, device=dev)
    owners = torch.empty((total,), dtype=torch.int32, device=dev)
    hist = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    _build.launch(
        "expand",
        tab.data_ptr(), n, rect_min_x.data_ptr(), rect_min_y.data_ptr(), rect_w.data_ptr(),
        count.data_ptr(), offsets.data_ptr(), gx, num_tiles,
        keys.data_ptr(), owners.data_ptr(), hist.data_ptr(), _build.stream_of(tab),
    )
    return keys, owners, hist
