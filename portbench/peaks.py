"""Peaks of the card a roofline share is taken against.

One NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's data sheet,
dense rates): HBM3 at 3.35 TB/s and 67 TFLOP/s of float32 on the CUDA
cores, the constants and the bound of ``chip_smoke.py`` (``PEAK_BYTES``,
``PEAK_F32``, ``bound()``, lines 3229-3239 at the commit that added this
benchmark).  A card set below 700 W runs slower under load; the harness
prints the power limit beside every share.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take for a launch: each input byte
    read once and each output byte written once at the memory rate,
    against the float32 operations at the float32 peak."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)
