"""3x3 per-slice median filter for binary defect masks.

Counterpart of ``ventjax/ops/median.py``: for a 0/1 input the zero-padded
3x3 median (scipy.signal.medfilt2d) is "at least 5 of the 9 window entries
are 1", i.e. one zero-padded 3x3 box sum and a compare.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def median3x3_binary(x: torch.Tensor) -> torch.Tensor:
    """Per-slice 3x3 zero-padded median of a binary [N,H,W,D] volume."""
    N, H, W, D = x.shape
    p = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))   # pad W and H by 1
    counts = sum(p[:, i:i + H, j:j + W, :]
                 for i in range(3) for j in range(3))
    return (counts >= 5.0).to(torch.float32)
