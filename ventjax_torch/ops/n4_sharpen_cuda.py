"""N4's histogram-sharpen kernels K4 and K5: CUDA wrappers and plain versions.

Counterpart of the sharpen half of ``ventjax/ops/n4_pallas.py``.  One N4
iteration sharpens each lane's masked log residual ``logu`` (weights ``wv``)
in three steps; the first and last are kernels (``csrc/n4_sharpen.cu``):

- ``sharpen_hist`` (K4; replaces ``sharpen_hist_pallas``): the fractional
  histogram over ``bins`` bins from ``binmin`` in steps of ``slope``; each
  voxel adds ``wv*(1-f)`` to bin ``floor(t)`` and ``wv*f`` to the next,
  ``t = clip((logu - binmin)/slope, 0, bins-1) * wv``.  The kernel sums in
  64-bit fixed point with integer atomics, so it gives the same bits on
  every run.
- ``ops.n4._sharpen_expectation`` (plain PyTorch, FFTs): the conditional
  expectation table ``e_loc`` [N, bins+2] of the slots ``t + 1`` can reach.
- ``sharpen_resid`` (K5; replaces ``sharpen_resid_pallas``): the B-spline fit
  target ``((logu - interp(e_loc, t+1)*wv)*wv``, flushed below 1e-18 and
  divided by ``max(sv, 1e-30)``; 0 where ``wv = 0``.

A NaN ``(logu - binmin)/slope`` (a lane with no weighted voxel, or slope 0)
clips to 0 and every slot index is clamped to ``[0, bins]``, so such lanes
give finite output.  Each wrapper runs its plain version for a CPU tensor,
launches its kernel for a CUDA tensor, and raises for anything else.  K5
and its plain version compute the same float32 operations in the same
order: they agree bit for bit.  K4 agrees with its plain version up to the
plain version's float32 summation order.
"""
from __future__ import annotations

import ctypes

import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream

# bins + 2 histogram slots per lane at most: the kernels' shared-memory
# budget (csrc/n4_sharpen.cu MAX_SLOTS).
MAX_SLOTS = 768
# Kernel launches per wrapper since the counts were last set to 0.
LAUNCHES = {"sharpen_hist": 0, "sharpen_resid": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("n4_sharpen")
    if not getattr(lib, "_vj_typed", False):
        lib.vj_sharpen_chunk.argtypes = []
        lib.vj_sharpen_chunk.restype = _I
        lib.vj_sharpen_max_slots.argtypes = []
        lib.vj_sharpen_max_slots.restype = _I
        lib.vj_sharpen_hist.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.vj_sharpen_hist.restype = _I
        lib.vj_sharpen_resid.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.vj_sharpen_resid.restype = _I
        lib._vj_typed = True
        if lib.vj_sharpen_max_slots() != MAX_SLOTS:
            raise RuntimeError("n4_sharpen: MAX_SLOTS differs from the "
                               "kernel source")
    return lib


def _check_shapes(name, logu, wv, binmin, slope, bins):
    if logu.dim() != 2 or wv.shape != logu.shape:
        raise ValueError(f"{name}: logu and wv must share one [N, P] shape, "
                         f"got {tuple(logu.shape)}, {tuple(wv.shape)}")
    N = logu.shape[0]
    if binmin.shape != (N,) or slope.shape != (N,):
        raise ValueError(f"{name}: binmin and slope must be [{N}], got "
                         f"{tuple(binmin.shape)}, {tuple(slope.shape)}")
    if not 2 <= bins <= MAX_SLOTS - 2:
        raise ValueError(f"{name}: bins={bins} is outside 2..{MAX_SLOTS - 2}"
                         f" (bins + 2 slots must fit the kernels' shared "
                         f"memory)")
    return logu.shape


def _t_index(logu, wv, binmin, slope, bins):
    """clip((logu - binmin)/slope, 0, bins-1) * wv, NaN clipped to 0."""
    x = (logu - binmin[:, None]) / slope[:, None]
    return x.nan_to_num(nan=0.0).clamp(0.0, float(bins - 1)) * wv


def _split(t, bins):
    """(slot index floor(t) clamped to [0, bins], fraction t - floor(t))."""
    fl = torch.floor(t)
    return fl.to(torch.int64).clamp(0, bins), t - fl


# ---------------------------------------------------------------------------
# K4: fractional histogram.


def sharpen_hist_plain(logu, wv, binmin, slope, bins):
    """Plain PyTorch version of K4: [N, bins] float32."""
    N, _ = logu.shape
    i0, f = _split(_t_index(logu, wv, binmin, slope, bins), bins)
    hist = torch.zeros((N, bins + 2), dtype=logu.dtype, device=logu.device)
    hist.scatter_add_(1, i0, wv * (1.0 - f))
    hist.scatter_add_(1, i0 + 1, wv * f)
    return hist[:, :bins]


def sharpen_hist(logu, wv, binmin, slope, bins):
    """K4: logu, wv [N, P]; binmin, slope [N] -> hist [N, bins] float32."""
    N, P = _check_shapes("sharpen_hist", logu, wv, binmin, slope, bins)
    check("sharpen_hist", logu, wv, binmin, slope)
    if not route("sharpen_hist", logu):
        return sharpen_hist_plain(logu, wv, binmin, slope, bins)
    lib = _lib()
    nchunk = -(-P // lib.vj_sharpen_chunk())
    part = torch.empty((N, nchunk, bins + 2), dtype=torch.int64,
                       device=logu.device)
    hist = torch.empty((N, bins), dtype=torch.float32, device=logu.device)
    rc = lib.vj_sharpen_hist(
        logu.data_ptr(), wv.data_ptr(), binmin.data_ptr(), slope.data_ptr(),
        part.data_ptr(), hist.data_ptr(), N, P, bins, nchunk,
        stream(logu.device))
    raise_on(rc, "sharpen_hist")
    LAUNCHES["sharpen_hist"] += 1
    return hist


# ---------------------------------------------------------------------------
# K5: expectation interpolation, residual, flush, normalisation.


def sharpen_resid_plain(logu, wv, sv, e_loc, binmin, slope, bins):
    """Plain PyTorch version of K5: a [N, P] float32."""
    j0, fs = _split(_t_index(logu, wv, binmin, slope, bins) + 1.0, bins)
    v = (1.0 - fs) * e_loc.gather(1, j0) + fs * e_loc.gather(1, j0 + 1)
    r = (logu - v * wv) * wv
    r = torch.where(r.abs() < 1e-18, torch.zeros_like(r), r)
    return torch.where(wv > 0, r / sv.clamp_min(1e-30), torch.zeros_like(r))


def sharpen_resid(logu, wv, sv, e_loc, binmin, slope, bins):
    """K5: logu, wv, sv [N, P]; e_loc [N, bins+2]; binmin, slope [N] ->
    the fit target a [N, P] float32."""
    N, P = _check_shapes("sharpen_resid", logu, wv, binmin, slope, bins)
    if sv.shape != (N, P) or e_loc.shape != (N, bins + 2):
        raise ValueError(f"sharpen_resid: sv {tuple(sv.shape)} and e_loc "
                         f"{tuple(e_loc.shape)}, expected {(N, P)} and "
                         f"{(N, bins + 2)}")
    check("sharpen_resid", logu, wv, sv, e_loc, binmin, slope)
    if not route("sharpen_resid", logu):
        return sharpen_resid_plain(logu, wv, sv, e_loc, binmin, slope, bins)
    lib = _lib()
    a = torch.empty((N, P), dtype=torch.float32, device=logu.device)
    rc = lib.vj_sharpen_resid(
        logu.data_ptr(), wv.data_ptr(), sv.data_ptr(), e_loc.data_ptr(),
        binmin.data_ptr(), slope.data_ptr(), a.data_ptr(), N, P, bins,
        stream(logu.device))
    raise_on(rc, "sharpen_resid")
    LAUNCHES["sharpen_resid"] += 1
    return a
