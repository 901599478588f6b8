"""N4's B-spline fit kernels K1 and K2: CUDA wrappers and plain versions.

Counterpart of ``ventjax/ops/n4_pallas.py``.  Both kernels work on the
compacted masked voxels of a batch of N lanes, with the per-voxel cubic
B-spline basis rows streamed as ``[N, ncp, P]`` float32 tensors (one per
axis; powered once per level by the caller):

- ``fit_moment`` (K1, ``csrc/n4_fit.cu``; replaces ``fit_moment_pallas``):
  ``mom[n, c, d*ncp+e] = sum_p a[n,p] br[n,c,p] bc[n,d,p] bs[n,e,p]``, the
  Lee-BA fit numerator (a = residual, rows cubed) or denominator
  (a = weights, rows squared).
- ``fit_delta_conv_field`` (K2; replaces ``fit_delta_conv_field_pallas``):
  ``delta = B phi`` at every voxel (flushed below 1e-18, times the weight),
  the done-frozen field update, the next log residual and its masked range,
  and ITK's convergence sums, in one pass.

Each wrapper runs its plain PyTorch version for a CPU tensor, launches the
kernel for a CUDA tensor, and raises for anything else.  Everything is
float32; the kernels and plain versions share one algorithm and differ
only in summation order.
"""
from __future__ import annotations

import ctypes

import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream

MAX_NCP = 16
# Kernel launches per wrapper since the counts were last set to 0.
LAUNCHES = {"fit_moment": 0, "fit_delta_conv_field": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("n4_fit")
    if not getattr(lib, "_vj_typed", False):
        lib.vj_n4_chunk.argtypes = []
        lib.vj_n4_chunk.restype = _I
        lib.vj_fit_moment.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.vj_fit_moment.restype = _I
        lib.vj_fit_delta_conv_field.argtypes = [_P] * 12 + [_I] * 4 + [_P]
        lib.vj_fit_delta_conv_field.restype = _I
        lib._vj_typed = True
    return lib


def _check_rows(name, br, bc, bs):
    if br.dim() != 3 or br.shape != bc.shape or br.shape != bs.shape:
        raise ValueError(f"{name}: basis rows must share one [N, ncp, P] "
                         f"shape, got {br.shape}, {bc.shape}, {bs.shape}")
    ncp = br.shape[1]
    if not 1 <= ncp <= MAX_NCP:
        raise ValueError(f"{name}: ncp={ncp} is outside the kernels' "
                         f"supported range 1..{MAX_NCP}")
    return br.shape


# ---------------------------------------------------------------------------
# K1: fit moment.


def fit_moment_plain(a, br, bc, bs):
    """[N, ncp, ncp*ncp] moment matrix (plain PyTorch version of K1)."""
    N, ncp, P = br.shape
    bo = (bc[:, :, None, :] * bs[:, None, :, :]).reshape(N, ncp * ncp, P)
    return torch.bmm(a[:, None, :] * br, bo.transpose(1, 2))


def fit_moment(a, br, bc, bs):
    """K1: a [N, P]; br/bc/bs [N, ncp, P] -> [N, ncp, ncp*ncp] float32."""
    N, ncp, P = _check_rows("fit_moment", br, bc, bs)
    if a.shape != (N, P):
        raise ValueError(f"fit_moment: a is {tuple(a.shape)}, "
                         f"expected {(N, P)}")
    check("fit_moment", a, br, bc, bs)
    if not route("fit_moment", a):
        return fit_moment_plain(a, br, bc, bs)
    lib = _lib()
    nchunk = -(-P // lib.vj_n4_chunk())
    n3 = ncp ** 3
    part = torch.empty((N, nchunk, n3), device=a.device, dtype=torch.float32)
    out = torch.empty((N, ncp, ncp * ncp), device=a.device,
                      dtype=torch.float32)
    rc = lib.vj_fit_moment(
        a.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
        part.data_ptr(), out.data_ptr(), N, P, ncp, nchunk,
        stream(a.device))
    raise_on(rc, "fit_moment")
    LAUNCHES["fit_moment"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: fused field update + next residual + convergence sums.


def fit_delta_conv_field_plain(phi, br, bc, bs, wv, field, logv, done):
    """Plain PyTorch version of K2; see ``fit_delta_conv_field``."""
    N, ncp, P = br.shape
    bo = (bc[:, :, None, :] * bs[:, None, :, :]).reshape(N, ncp * ncp, P)
    g = torch.bmm(phi.reshape(N, ncp, ncp * ncp), bo)         # [N, ncp, P]
    raw = (br * g).sum(1)
    d = torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw) * wv
    nf = field + (1.0 - done)[:, None] * d
    lu = (logv - nf) * wv
    e1 = torch.exp(-d) - 1.0
    inf = torch.full_like(lu, float("inf"))
    stats = torch.stack([
        (wv * e1).sum(1),
        (wv * e1 * e1).sum(1),
        torch.where(wv > 0, lu, inf).min(1).values,
        torch.where(wv > 0, lu, -inf).max(1).values,
    ], dim=1)
    return nf, lu, stats


def fit_delta_conv_field(phi, br, bc, bs, wv, field, logv, done):
    """K2: one N4 iteration tail for every lane.

    phi [N, ncp, ncp*ncp] coefficients; br/bc/bs [N, ncp, P] power-1 rows;
    wv/field/logv [N, P]; done [N] float (1.0 = lane converged, frozen).
    Returns (field' [N, P], logu' [N, P], stats [N, 4]) with
    field' = field + (1 - done) * delta, logu' = (logv - field') * wv and
    stats = (sum wv*(e^-delta - 1), sum wv*(e^-delta - 1)^2,
    masked min logu', masked max logu').
    """
    N, ncp, P = _check_rows("fit_delta_conv_field", br, bc, bs)
    if phi.shape != (N, ncp, ncp * ncp):
        raise ValueError(f"fit_delta_conv_field: phi is {tuple(phi.shape)}")
    for t in (wv, field, logv):
        if t.shape != (N, P):
            raise ValueError(f"fit_delta_conv_field: vector {tuple(t.shape)}"
                             f", expected {(N, P)}")
    if done.shape != (N,):
        raise ValueError(f"fit_delta_conv_field: done is {tuple(done.shape)}")
    check("fit_delta_conv_field", phi, br, bc, bs, wv, field, logv, done)
    if not route("fit_delta_conv_field", wv):
        return fit_delta_conv_field_plain(phi, br, bc, bs, wv, field, logv,
                                          done)
    lib = _lib()
    nchunk = -(-P // lib.vj_n4_chunk())
    kw = dict(device=wv.device, dtype=torch.float32)
    nf = torch.empty((N, P), **kw)
    lu = torch.empty((N, P), **kw)
    part = torch.empty((N, nchunk, 4), **kw)
    stats = torch.empty((N, 4), **kw)
    rc = lib.vj_fit_delta_conv_field(
        phi.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
        wv.data_ptr(), field.data_ptr(), logv.data_ptr(), done.data_ptr(),
        nf.data_ptr(), lu.data_ptr(), part.data_ptr(), stats.data_ptr(),
        N, P, ncp, nchunk, stream(wv.device))
    raise_on(rc, "fit_delta_conv_field")
    LAUNCHES["fit_delta_conv_field"] += 1
    return nf, lu, stats
