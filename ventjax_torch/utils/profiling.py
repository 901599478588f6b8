"""Tracing and timing helpers: the counterparts of ``ventjax/utils/profiling.py``
that the cohort and serve entry points use.

- ``trace(profile_dir)`` wraps a block in ``torch.profiler`` (CPU and, where
  a card is present, CUDA activity) and writes a Chrome trace into the
  directory when one is given;
- ``stage(name)`` is ``torch.profiler.record_function`` while the calling
  thread's profiler records, so the pipeline's stages (snr, n4, the three
  VDPs, ci) and the spans inside them show as named ranges in a trace;
  otherwise it is one shared null context, which costs one C call;
- ``host_wait(name)`` is the one wrapper around every point where the host
  waits for the card: a ``stage`` span, named ``<stage>.sync``, that also
  lets the wait through while ``torch.cuda.set_sync_debug_mode`` is on, so
  a run under mode "error" proves every sync on the path declared;
- ``timed(name)`` measures wall time; put a ``sync`` inside the block, since
  PyTorch returns before the card finishes;
- ``sync()`` waits for the card;
- ``enable_deterministic()`` sets the flags the port's bit-reproducibility
  rests on;
- ``enable_debug_checks()`` (JAX's ``jax_debug_nans``/``jax_debug_infs``
  in ventjax) makes each stage of ``analyze_cohort`` check what it
  produced (``check_stage``).

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


_DEBUG_CHECKS = {"nans": False, "infs": False}


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    """While on, each stage of ``analyze_cohort`` checks the floating
    outputs it produced, on the lanes whose mask is not empty (an invalid
    lane's NaN metrics are by design), and raises FloatingPointError
    naming the stage at the first NaN (``nans``) or infinity (``infs``).
    ``enable_debug_checks(False, False)`` turns them off again; off, a
    check costs no sync and no launch."""
    _DEBUG_CHECKS.update(nans=bool(nans), infs=bool(infs))


def check_stage(name: str, valid, *outputs) -> None:
    """The debug check of one stage (see ``enable_debug_checks``):
    ``outputs`` are tensors, or tuples of them, with lanes along dim 0;
    ``valid`` [N] selects the lanes checked (None: all)."""
    nans, infs = _DEBUG_CHECKS["nans"], _DEBUG_CHECKS["infs"]
    if not (nans or infs):
        return
    flat = []
    for x in outputs:
        flat += list(x) if isinstance(x, (tuple, list)) else [x]
    for i, x in enumerate(flat):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        lanes = x if valid is None else x[valid.to(x.device)]
        for kind, on, bad in (("NaN", nans, torch.isnan),
                              ("Inf", infs, torch.isinf)):
            if on and bool(bad(lanes).any()):
                raise FloatingPointError(
                    f"debug checks: stage {name!r} produced {kind} in its "
                    f"output {i} (shape {tuple(x.shape)})")


_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
# The sync-debug mode's getter and setter (absent from a build without CUDA,
# where no sync can happen).
_get_sync_mode = getattr(torch._C, "_cuda_get_sync_debug_mode", lambda: 0)
_set_sync_mode = getattr(torch._C, "_cuda_set_sync_debug_mode", None)


def stage(name: str):
    """A named range in a torch.profiler trace while the calling thread's
    profiler records (a range on a thread no session watches is not
    recorded anyway); otherwise the shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def host_wait(name: str):
    """``stage(name)`` around a point where the host waits for the card
    (a device-to-host read, a pageable host-to-device copy).  While the
    sync-debug mode is on it is set to 0 inside and restored after, so
    only undeclared syncs warn or raise.  Off, two C calls."""
    mode = _get_sync_mode()
    if mode:
        return _declared_wait(name, mode)
    return stage(name)


@contextlib.contextmanager
def _declared_wait(name: str, mode: int) -> Iterator[None]:
    _set_sync_mode(0)
    try:
        with stage(name):
            yield
    finally:
        _set_sync_mode(mode)


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
