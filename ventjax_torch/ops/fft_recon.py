"""K-space reconstruction for raw (TWIX) data.

Counterpart of ``ventjax/ops/fft_recon.py``: the reference's per-slice
``fftshift(fft2(fftshift(k)))`` (Vent_Analysis.py:537-540), then transpose
(1, 0, 2) and flip the column axis, batched over slices.  Here it is
``torch.fft`` on complex64 tensors on the device (cuFFT on a card); the
DFT-as-matmul on split real/imaginary planes of the reference package is a
TPU workaround and is not carried over.

The entry points take host k-space and return host arrays (complex64, or
float32 for the coil combine), as the reference package's do; they run on
the CUDA card unless ``device="cpu"`` is given, and raise without a card.
"""
from __future__ import annotations

import numpy as np
import torch

from ventjax_torch.utils.device import resolve_device


def _recon(k: torch.Tensor) -> torch.Tensor:
    """[..., H, W, S] complex k-space -> complex image stack in the
    reference's orientation ([..., W, H, S], columns flipped)."""
    dims = (-3, -2)
    img = torch.fft.fftshift(
        torch.fft.fft2(torch.fft.fftshift(k, dim=dims), dim=dims), dim=dims)
    return torch.flip(img.transpose(-3, -2), dims=(-2,))


def _to_device(kspace, device) -> torch.Tensor:
    k = np.asarray(kspace).astype(np.complex64)
    return torch.from_numpy(k).to(resolve_device(device))


def recon_2d_multislice(kspace, device="cuda") -> np.ndarray:
    """[H, W, S] complex k-space -> complex64 image stack [W, H, S] with
    the reference's orientation (transpose + column flip)."""
    return _recon(_to_device(kspace, device)).cpu().numpy()


def recon_2d_multislice_rss(kspace_mc, device="cuda") -> np.ndarray:
    """[C, H, W, S] multi-coil k-space -> float32 root-sum-of-squares
    magnitude stack [W, H, S], in the reference's orientation.

    The reference's process_RAW is single-coil only; this is the standard
    coil combine for data it cannot ingest: per-coil recon, then
    sqrt(sum_c |img_c|^2).
    """
    img = _recon(_to_device(kspace_mc, device))
    return torch.sqrt((img.real ** 2 + img.imag ** 2).sum(0)).cpu().numpy()
