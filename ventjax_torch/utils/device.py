"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device a run asked for; a CUDA device without a card
    raises, so nothing falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but no CUDA card is available "
                f"(torch.cuda.is_available() is False); pass device=\"cpu\" "
                f"to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
