"""Tracing and timing helpers: the counterparts of ``ventjax/utils/profiling.py``
that the cohort and serve entry points use.

- ``trace(profile_dir)`` wraps a block in ``torch.profiler`` (CPU and, where
  a card is present, CUDA activity) and writes a Chrome trace into the
  directory when one is given;
- ``stage(name)`` is ``torch.profiler.record_function``, so the pipeline's
  stages (snr, n4, the three VDPs, ci) show as named ranges in a trace;
- ``timed(name)`` measures wall time; put a ``sync`` inside the block, since
  PyTorch returns before the card finishes;
- ``sync()`` waits for the card;
- ``enable_deterministic()`` sets the flags the port's bit-reproducibility
  rests on.

The reference package's persistent XLA compile cache has no counterpart:
the port's kernels are built once by nvcc into ``build/`` and reused.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def stage(name: str):
    """A named range in a torch.profiler trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(name: str, sink=print) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    sink(f"[ventjax_torch] {name}: {time.perf_counter() - t0:.3f}s")


def sync() -> None:
    """Wait for the work queued on the card (a no-op without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def enable_deterministic() -> None:
    """The switches the port's bit-reproducible results rest on: full
    float32 products (TF32 off for matmuls and cuDNN) and cuDNN's
    deterministic algorithms.  The port's own kernels sum without float
    atomics, so they need no switch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
