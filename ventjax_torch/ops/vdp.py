"""Ventilation Defect Percentage (mean-anchored and linear-binning).

Counterpart of ``ventjax/ops/vdp.py``, batched over ``[N, H, W, D]``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ventjax_torch.ops.basic import masked_mean, masked_sorted_index
from ventjax_torch.ops.median import median3x3_binary


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(1)


def vdp_mean_anchored(n4: torch.Tensor, mask: torch.Tensor,
                      thresh: float = 0.6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(defect [N,H,W,D] 0/1, VDP [N] percent):
    defect = medfilt3x3((n4 / mean(n4[mask]) < thresh) * mask) per slice."""
    m = (mask > 0).to(n4.dtype)
    mean_sig = masked_mean(n4, m)
    raw = (n4 / mean_sig[:, None, None, None] < thresh).to(n4.dtype) * m
    defect = median3x3_binary(raw)
    return defect, 100.0 * _count(defect) / _count(mask)


def vdp_linear_binning(
    n4: torch.Tensor,
    mask: torch.Tensor,
    edges: Tuple[float, ...] = (0.16, 0.34, 0.52, 0.70, 0.88),
    percentile: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bin map [N,H,W,D], VDP_lb [N]): six bins of n4 over its masked
    floor-index 99th percentile; VDP_lb counts bins 1 and 2."""
    m = (mask > 0).to(n4.dtype)
    denom = masked_sorted_index(n4, m, percentile)
    lb = linear_bins(n4, mask, denom, edges)
    vdp_lb = 100.0 * (_count(lb == 1) + _count(lb == 2)) / _count(mask)
    return lb, vdp_lb


def linear_bins(n4: torch.Tensor, mask: torch.Tensor, denom: torch.Tensor,
                edges: Tuple[float, ...]) -> torch.Tensor:
    """The six-bin map of n4 / denom ([N] per lane) over the mask."""
    norm = n4 / denom[:, None, None, None]
    e = edges
    f = lambda b: b.to(n4.dtype)
    return (
        f(norm <= e[0]) * 1.0
        + f(norm > e[0]) * f(norm <= e[1]) * 2.0
        + f(norm > e[1]) * f(norm <= e[2]) * 3.0
        + f(norm > e[2]) * f(norm <= e[3]) * 4.0
        + f(norm > e[3]) * f(norm <= e[4]) * 5.0
        + f(norm > e[4]) * 6.0
    ) * mask
