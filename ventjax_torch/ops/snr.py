"""SNR with the reference's exact noise-mask construction.

Counterpart of ``ventjax/ops/snr.py``, batched over ``[N, H, W, D]``.  The
noise mask keeps the reference's index quirks: the zeroed region is the
outer product of the rows that meet the mask plus row 0 (unless every row
does), the half-open column range [min positive masked col, max masked col),
and the slices like the rows; then the first and last ``fov_buffer`` rows
are zeroed.  SNR = (mean(signal) - mean(noise)) / std(noise), population std.
"""
from __future__ import annotations

import torch

from ventjax_torch.ops.basic import masked_mean, masked_std


def noise_mask(mask: torch.Tensor, fov_buffer: int = 20) -> torch.Tensor:
    """[N,H,W,D] float mask of noise voxels (1 = noise)."""
    N, H, W, D = mask.shape
    dev = mask.device
    m = mask > 0
    row_has = m.any(dim=3).any(dim=2)           # [N, H]
    col_has = m.any(dim=3).any(dim=1)           # [N, W]
    slc_has = m.any(dim=2).any(dim=1)           # [N, D]
    r_idx = torch.arange(H, device=dev)
    c_idx = torch.arange(W, device=dev)
    s_idx = torch.arange(D, device=dev)

    # (has * index) products include 0 whenever some index has no mask.
    row_zero = row_has | ((r_idx == 0)[None] & ~row_has.all(1, keepdim=True))
    slc_zero = slc_has | ((s_idx == 0)[None] & ~slc_has.all(1, keepdim=True))

    big = torch.full_like(c_idx, W + 1)
    col_pos = torch.where(col_has & (c_idx > 0)[None], c_idx[None], big[None])
    min_pos = col_pos.min(1, keepdim=True).values
    max_col = torch.where(col_has, c_idx[None],
                          torch.zeros_like(c_idx)[None]).max(1, keepdim=True)
    col_zero = (c_idx[None] >= min_pos) & (c_idx[None] < max_col.values)

    zeroed = (row_zero[:, :, None, None] & col_zero[:, None, :, None]
              & slc_zero[:, None, None, :])
    buffer_rows = (r_idx < fov_buffer) | (r_idx >= H - fov_buffer)
    keep = ~zeroed & ~buffer_rows[None, :, None, None]
    return keep.to(torch.float32)


def calculate_snr(a: torch.Tensor, mask: torch.Tensor,
                  fov_buffer: int = 20) -> torch.Tensor:
    """[N] SNR of each volume of a [N,H,W,D] batch."""
    nm = noise_mask(mask, fov_buffer)
    sig_mean = masked_mean(a, (mask > 0).to(a.dtype))
    return (sig_mean - masked_mean(a, nm)) / masked_std(a, nm)
