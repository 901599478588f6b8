"""2-D Haar wavelet decomposition / reconstruction / denoising.

Counterpart of ``ventjax/ops/wavelet.py``: the reference's roadmap
"Denoise Option", prototyped in its playground script with pywt's Haar
dwt2/idwt2 and detail-coefficient thresholding.  The orthonormal 2-D Haar
transform written directly in PyTorch, slice-wise over [H,W,D] volumes, on
the input's device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def haar_dwt2(x: torch.Tensor) -> Tuple[
        torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Single-level orthonormal Haar DWT of [..., H, W] (H, W even).

    Returns (cA, (cH, cV, cD)) with pywt's layout: cH = horizontal detail
    (varies along rows), cV = vertical detail, cD = diagonal.
    """
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ca = (a + b + c + d) / 2.0
    ch = (a + b - c - d) / 2.0
    cv = (a - b + c - d) / 2.0
    cd = (a - b - c + d) / 2.0
    return ca, (ch, cv, cd)


def haar_idwt2(ca: torch.Tensor, coeffs) -> torch.Tensor:
    """Inverse of haar_dwt2 (perfect reconstruction)."""
    ch, cv, cd = coeffs
    h2, w2 = ca.shape[-2], ca.shape[-1]
    out = torch.zeros((*ca.shape[:-2], h2 * 2, w2 * 2), dtype=ca.dtype,
                      device=ca.device)
    out[..., 0::2, 0::2] = (ca + ch + cv + cd) / 2.0
    out[..., 0::2, 1::2] = (ca + ch - cv - cd) / 2.0
    out[..., 1::2, 0::2] = (ca - ch + cv - cd) / 2.0
    out[..., 1::2, 1::2] = (ca - ch - cv + cd) / 2.0
    return out


def denoise_volume(volume: torch.Tensor, threshold: float, levels: int = 1,
                   soft: bool = False) -> torch.Tensor:
    """Haar wavelet denoising of an [H,W,D] volume, slice by slice
    (float32).

    Detail coefficients with |c| <= threshold are zeroed (hard, the
    playground's apply_threshold) or shrunk (soft thresholding).
    """
    H, W = volume.shape[0], volume.shape[1]
    step = 1 << levels
    if H % step or W % step:
        raise ValueError(
            f"H and W must be divisible by 2**levels={step} for the Haar "
            f"DWT (got {H}x{W}); pad or crop the volume first")
    x = torch.movedim(torch.as_tensor(volume), -1, 0).to(torch.float32)

    def thresh(c):
        if soft:
            return torch.sign(c) * torch.clamp(c.abs() - threshold, min=0.0)
        return torch.where(c.abs() > threshold, c, torch.zeros_like(c))

    def denoise_level(x, level):
        if level == 0:
            return x
        ca, (ch, cv, cd) = haar_dwt2(x)
        ca = denoise_level(ca, level - 1)
        return haar_idwt2(ca, (thresh(ch), thresh(cv), thresh(cd)))

    return torch.movedim(denoise_level(x, levels), 0, -1)
