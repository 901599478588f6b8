"""What every kernel wrapper of the port does around a launch.

A wrapper checks devices, types and contiguity on either route
(``check``), so that the CPU tests hold the callers to what the kernels
take; it then takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (``route``).  The C entry points take
PyTorch's current stream (``stream``) and return ``cudaGetLastError()``,
which ``raise_on`` turns into an exception.  There is no fallback from a
kernel to a plain version.
"""
from __future__ import annotations

import torch


def route(name, t):
    """False for a CPU tensor (plain version), True for CUDA (kernel)."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise RuntimeError(f"{name}: no kernel for device {t.device}")


def check(name, *ts, dtype=torch.float32):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
