"""Approximate 3-nearest-neighbour distances by Morton-sorted blocks.

Counterpart of `guidedvd3dgs_tpu/ops/knn.py::dist_knn3` (plain XLA there,
no Pallas kernel; plain torch here), written as the same algorithm so that
the init scales and the split and proximity picks agree with the
reference:
  1. Morton codes of the points normalized into their bounding box, the
     grid shifted by p / passes^2 of the box in pass p;
  2. a stable sort of the codes; blocks of B = 128 sorted points, each
     point's candidates its own block and both neighbours (3B);
  3. the 3 nearest candidates by |x|^2 + |c|^2 - 2 x.c, ties broken by the
     larger sorted position;
  4. the passes' candidates merged by distance with duplicates dropped,
     then the exact squared distances of the 3 picks.
Returns (mean squared distance clamped at 1e-7 (N,), indices (N, 3)).
"""

from __future__ import annotations

import torch

from guidedvd3dgs_tpu_torch.utils import tracing

B = 128  # Morton block size
PASSES = 3  # shifted-grid repeats
# blocks per distance tile: bounds the (GB, B, 3B) f32 temporaries
GB_CPU, GB_CUDA = 64, 2048

_M = (0x00010001, 0xFF0000FF, 0x00000101, 0x0F00F00F, 0x00000011, 0xC30C30C3, 0x00000005, 0x49249249)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64 holding uint32 values) two zero
    bits apart, with uint32 wraparound as the reference computes."""
    mask32 = 0xFFFFFFFF
    for mul, keep in zip(_M[0::2], _M[1::2]):
        v = ((v * mul) & mask32) & keep
    return v


def morton_codes(points: torch.Tensor, shift: float = 0.0) -> torch.Tensor:
    """30-bit Morton codes (int64) of points normalized into their bounding
    box, the quantization grid offset by `shift` of the box."""
    pmin = points.min(dim=0).values
    pmax = points.max(dim=0).values
    extent = torch.clamp(pmax - pmin, min=1e-9)
    q = torch.clamp((points - pmin) / extent, 0.0, 1.0)
    cells = torch.clamp((q * 1024.0 + shift * 1024.0).to(torch.int64), max=1023)
    ex, ey, ez = (_expand_bits(cells[:, i]) for i in range(3))
    return (ex << 2) | (ey << 1) | ez


def _top3_blocks(xs, cand, cpos, xp, cvalid):
    """xs (G, B, 3), cand (G, 3B, 3), positions cpos (G, 3B) / xp (G, B),
    cvalid (G, 3B): the 3 smallest selection distances and their sorted
    positions per point, ties to the larger position."""
    xc = torch.einsum("gid,gjd->gij", xs, cand)
    d2 = (xs * xs).sum(-1)[:, :, None] + (cand * cand).sum(-1)[:, None, :] - 2.0 * xc
    live = cvalid[:, None, :] & (cpos[:, None, :] != xp[:, :, None])
    with tracing.readback():  # a blocking copy to the card
        inf = torch.tensor(float("inf"), device=xs.device)
    d2 = torch.where(live, torch.clamp(d2, min=0.0), inf)
    cpos_b = cpos[:, None, :].expand_as(d2)
    outs_d, outs_p = [], []
    for _ in range(3):
        dv = d2.min(dim=-1).values
        at_min = d2 <= dv[..., None]
        pv = torch.where(at_min, cpos_b, torch.full_like(cpos_b, -(2**31) + 1)).max(dim=-1).values
        outs_d.append(dv)
        outs_p.append(pv)
        d2 = torch.where(cpos_b == pv[..., None], inf, d2)
    return torch.stack(outs_d, -1), torch.stack(outs_p, -1)


def _pass(points: torch.Tensor, n_real: int, shift: float, gb: int):
    """One Morton pass over n points (n a multiple of B, the first `n_real`
    real): (selection d2 (n, 3), neighbour indices (n, 3), -1 where
    missing) in the original order."""
    n = points.shape[0]
    dev = points.device
    codes = morton_codes(points[:n_real], shift)
    key = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    key[:n_real] = codes
    _, order = torch.sort(key, stable=True)
    sp = points[order]
    smask = order < n_real
    nb = n // B
    blocks = sp.reshape(nb, B, 3)
    bmask = smask.reshape(nb, B)
    bpos = torch.arange(n, device=dev).reshape(nb, B)
    # one invalid block at each end: edge blocks see fewer candidates
    zb = torch.zeros((1, B, 3), dtype=sp.dtype, device=dev)
    blocks_p = torch.cat([zb, blocks, zb])
    mask_p = torch.cat([torch.zeros((1, B), dtype=torch.bool, device=dev), bmask,
                        torch.zeros((1, B), dtype=torch.bool, device=dev)])
    pos_p = torch.cat([torch.full((1, B), -1, device=dev), bpos, torch.full((1, B), -1, device=dev)])
    d_out = torch.empty((n, 3), dtype=sp.dtype, device=dev)
    p_out = torch.empty((n, 3), dtype=torch.int64, device=dev)
    for s in range(0, nb, gb):
        e = min(s + gb, nb)
        cs, cm, cp = blocks_p[s:e + 2], mask_p[s:e + 2], pos_p[s:e + 2]
        cand = torch.cat([cs[:-2], cs[1:-1], cs[2:]], dim=1)
        cvalid = torch.cat([cm[:-2], cm[1:-1], cm[2:]], dim=1)
        cpos = torch.cat([cp[:-2], cp[1:-1], cp[2:]], dim=1)
        d, p = _top3_blocks(blocks_p[s + 1:e + 1], cand, cpos, pos_p[s + 1:e + 1], cvalid)
        xm = mask_p[s + 1:e + 1]
        # a padding point gets inf / invalid (the reference masks its row)
        d = torch.where(xm[..., None], d, torch.full_like(d, float("inf")))
        d_out[s * B:e * B] = d.reshape(-1, 3)
        p_out[s * B:e * B] = p.reshape(-1, 3)
    nidx = torch.where(p_out >= 0, order[torch.clamp(p_out, 0, n - 1)], torch.full_like(p_out, -1))
    # back to the original order
    d_orig = torch.empty_like(d_out)
    i_orig = torch.empty_like(nidx)
    d_orig[order] = d_out
    i_orig[order] = nidx
    return d_orig, i_orig


def knn3(points: torch.Tensor, passes: int = PASSES):
    """(mean squared distance (N,), indices (N, 3)) of the 3 approximate
    nearest neighbours; a point without a valid neighbour gets 0 and its
    own index."""
    n0 = points.shape[0]
    dev = points.device
    npad = -(-n0 // B) * B
    pts = torch.cat([points, torch.zeros((npad - n0, 3), dtype=points.dtype, device=dev)])
    gb = GB_CUDA if dev.type == "cuda" else GB_CPU
    ds, is_ = [], []
    for p in range(passes):
        d, i = _pass(pts, n0, p / (passes * passes), gb)
        ds.append(d)
        is_.append(i)
    dall = torch.cat(ds, -1)
    iall = torch.cat(is_, -1)
    # merge: by distance, exact index duplicates dropped, best 3 kept
    dall, ordd = torch.sort(dall, dim=-1, stable=True)
    iall = torch.gather(iall, -1, ordd)
    k = dall.shape[-1]
    dup = (iall[:, :, None] == iall[:, None, :]) & torch.tril(
        torch.ones((k, k), dtype=torch.bool, device=dev), -1)[None]
    dall = torch.where(dup.any(-1), torch.full_like(dall, float("inf")), dall)
    ordm = torch.sort(dall, dim=-1, stable=True).indices[:, :3]
    d_sel = torch.gather(dall, -1, ordm)
    idx_sel = torch.gather(iall, -1, ordm)
    valid = torch.isfinite(d_sel) & (idx_sel >= 0)
    valid[n0:] = False
    # exact distances of the picks (the selection form carries cancellation noise)
    nb_pts = pts[torch.where(valid, idx_sel, torch.zeros_like(idx_sel))]
    d_exact = ((nb_pts - pts[:, None, :]) ** 2).sum(-1)
    cnt = valid.sum(-1)
    mean_d2 = torch.where(
        cnt > 0,
        torch.where(valid, d_exact, torch.zeros_like(d_exact)).sum(-1) / torch.clamp(cnt, min=1),
        torch.zeros_like(d_exact[:, 0]),
    )
    nn_idx = torch.where(valid, idx_sel, torch.arange(npad, device=dev)[:, None])
    return mean_d2[:n0], nn_idx[:n0]


def dist_knn3(points: torch.Tensor):
    """knn3 with the mean squared distance clamped at 1e-7."""
    d2, idx = knn3(points)
    return torch.clamp(d2, min=1e-7), idx
