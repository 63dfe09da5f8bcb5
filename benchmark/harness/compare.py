"""The arithmetic of the comparisons that decide `correct`."""

from __future__ import annotations

import math

import torch


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64; NaN where got is not finite."""
    g, w = got.detach().double(), want.detach().double()
    if not bool(torch.isfinite(g).all()):
        return math.nan
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp(min=1e-300))


def rel_to(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """||got - want|| / ||scale||: a gap measured against a change."""
    g, w = got.detach().double(), want.detach().double()
    if not bool(torch.isfinite(g).all()):
        return math.nan
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(scale.detach().double()).clamp(min=1e-300))
