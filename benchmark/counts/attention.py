"""Kernel L1's work in one DDIM step, from the configuration's shapes.

The least times are frozen copies of `chip_smoke.py::l1_bound` (q, k, v
read once and o written once, against the two products, 4 B H N^2 D
operations) and `l1_bwd_bounds` (dK/dV: q, k, v, dO, the log-sum-exp and
Delta read, dk and dv written, four n x n products, 8 B H N^2 D; dQ: the
same reads, dq written, three products, 6 B H N^2 D), at the peak of the
input type. The launches come from the layout as the port runs a step
(`chip_smoke.py::guided_launches`): the UNet's self-attentions at level 0
(the only ones of at least 1024 tokens) and the VAE decoder's mid-block
attention of each decode chunk.
"""

from __future__ import annotations

from typing import List, Tuple

from counts.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_s

FLASH_MIN_SEQ = 1024  # the port's nnops.FLASH_MIN_SEQ: shorter attention takes the einsum form


def fwd_s(shape, elem: int) -> float:
    b, h, n, d = shape
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    return bound_s(4 * b * h * n * d * elem, 4 * b * h * n * n * d, peak)


def bwd_s(shape, elem: int) -> Tuple[float, float]:
    b, h, n, d = shape
    elems, rows = b * h * n * d, b * h * n
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    reads = 4 * elems * elem + 2 * rows * 4
    return (bound_s(reads + 2 * elems * elem, 8 * rows * n * d, peak),
            bound_s(reads + elems * elem, 6 * rows * n * d, peak))


def level0_attentions(unet: dict) -> int:
    """Spatial transformers at the UNet's full resolution (ds = 1): the
    input and output blocks of level 0 (and the middle one where level 0
    is the deepest)."""
    if 1 not in unet["attention_resolutions"]:
        return 0
    n = 2 * unet["num_res_blocks"] + 1
    return n + (len(unet["channel_mult"]) == 1)


def step_launches(cfg: dict, traffic: dict) -> List[Tuple[str, tuple, int]]:
    """[(kind, shape, launches)] of L1 in one step; kind "fwd" or "bwd"."""
    unet, vae = cfg["unet"], cfg["vae"]
    t = traffic["frames"]
    f = 2 ** (len(vae["ch_mult"]) - 1)
    tokens = (traffic["height"] // f) * (traffic["width"] // f)
    if tokens < FLASH_MIN_SEQ:
        return []
    heads = unet["model_channels"] // unet["num_head_channels"]
    lvl0 = level0_attentions(unet)
    unet_shape = (t, heads, tokens, unet["num_head_channels"])
    if not traffic["guided"]:
        # the CFG pair as two applications at batch 1 (samplers/ddim.py::cfg_model_output)
        return [("fwd", unet_shape, 2 * lvl0)]
    chunk = traffic["decode_chunk"]
    chunks = [min(chunk, t - c0) for c0 in range(0, t, chunk)]
    vae_c = vae["ch"] * vae["ch_mult"][-1]
    out = [("fwd", (2 * t, heads, tokens, unet["num_head_channels"]), lvl0),  # the batched pair
           ("fwd", unet_shape, 2 * lvl0), ("bwd", unet_shape, 2 * lvl0)]  # each branch's VJP
    for c in chunks:
        out += [("fwd", (c, 1, tokens, vae_c), 1), ("bwd", (c, 1, tokens, vae_c), 1)]
    return out


def step_least_s(cfg: dict, traffic: dict, elem: int = 2) -> float:
    total = 0.0
    for kind, shape, n in step_launches(cfg, traffic):
        total += n * (fwd_s(shape, elem) if kind == "fwd" else sum(bwd_s(shape, elem)))
    return total
