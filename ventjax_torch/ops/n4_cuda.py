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
- ``fit_delta`` (K6; replaces ``fit_delta_pallas``): the raw ``delta = B
  phi``, with no flush and no weight.
- ``fit_delta_conv`` (K7; replaces ``fit_delta_conv_pallas``): the flushed,
  weighted delta and ITK's two convergence sums.

K2, K6 and K7 share their per-voxel delta and their sums, in the kernel and
in the plain versions alike: K7's outputs equal K2's with ``done = 0``, and
the flushed, weighted K6 equals K7's delta, bit for bit.  Only the unfused
fit chain (``chip_smoke.py``'s counterpart of
``benchmarks/n4_pallas_micro.py``) runs K6 and K7; N4 runs K1 and K2.

For a compacted list held in slabs (``ops/n4_space.py``), K1 and K2's
statistics come in two phases: ``fit_moment_partial`` writes K1's per-chunk
partials and ``fit_moment_reduce`` adds a concatenation of several slabs'
partials in chunk order; ``fit_delta_conv_field(..., return_part=True)``
also returns K2's per-chunk statistics, which ``fit_fold_stats`` folds as
K2's last block does.  A slab that launches over whole chunks of the list
then gives the one-launch bits.

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
CHUNK = 2048     # voxels per chunk of K1 and K2 (csrc/n4_fit.cu CHUNK)
# Kernel launches per wrapper since the counts were last set to 0.  The
# last two are no launches: N4's captured iterations and their replays
# (counters of ``ops/n4.py``'s level loop), kept here only because the
# benchmark's harness reads this dict whole (chip_smoke leaves them out of
# its launch counts).
LAUNCHES = {"fit_moment": 0, "fit_delta_conv_field": 0, "fit_delta": 0,
            "fit_delta_conv": 0, "fit_moment_partial": 0,
            "fit_moment_reduce": 0, "fit_fold_stats": 0,
            "n4_iter_graph_captures": 0, "n4_iter_graph_replays": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _typed(lib):
    """lib with the C signatures of csrc/n4_fit.cu set."""
    if not getattr(lib, "_vj_typed", False):
        lib.vj_n4_chunk.argtypes = []
        lib.vj_n4_chunk.restype = _I
        lib.vj_fit_moment_partial.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.vj_fit_moment_partial.restype = _I
        lib.vj_fit_moment_reduce.argtypes = [_P] * 2 + [_I] * 3 + [_P]
        lib.vj_fit_moment_reduce.restype = _I
        lib.vj_fit_fold_stats.argtypes = [_P] * 2 + [_I] * 2 + [_P]
        lib.vj_fit_fold_stats.restype = _I
        lib.vj_fit_delta_conv_field.argtypes = [_P] * 13 + [_I] * 4 + [_P]
        lib.vj_fit_delta_conv_field.restype = _I
        lib.vj_fit_delta.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.vj_fit_delta.restype = _I
        lib.vj_fit_delta_conv.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.vj_fit_delta_conv.restype = _I
        lib._vj_typed = True
        if lib.vj_n4_chunk() != CHUNK:
            raise RuntimeError("n4_fit: CHUNK differs from the kernel source")
    return lib


def _lib():
    return _typed(_build.load("n4_fit"))


# One ticket per lane for K2's and K7's last-block fold, per (device,
# stream): zero before and after every launch (the kernel resets its own),
# so launches in one stream share them.  Grown, and zeroed once, on demand;
# a CUDA graph captured on one keeps it alive (``ops/n4.py``).
_TICKETS = {}


def _tickets(dev, N):
    key = (dev.index, stream(dev))
    t = _TICKETS.get(key)
    if t is None or t.numel() < N:
        t = torch.zeros(max(N, 64), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


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
    with torch.cuda.device(a.device):
        # the two phases in turn, counted as one call
        rc = lib.vj_fit_moment_partial(
            a.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
            part.data_ptr(), N, P, ncp, nchunk, stream(a.device))
        if rc == 0:
            rc = lib.vj_fit_moment_reduce(part.data_ptr(), out.data_ptr(), N,
                                          ncp, nchunk, stream(a.device))
    raise_on(rc, "fit_moment")
    LAUNCHES["fit_moment"] += 1
    return out


def _chunked(t, nchunk):
    """[N, ..., P] -> [N, nchunk, ..., CHUNK], zero past P."""
    P = t.shape[-1]
    t = torch.nn.functional.pad(t, (0, nchunk * CHUNK - P))
    t = t.reshape(t.shape[:-1] + (nchunk, CHUNK))
    return t.movedim(-2, 1)


def fit_moment_partial_plain(a, br, bc, bs):
    """Plain PyTorch version of K1's first phase: [N, nchunk, ncp^3], the
    moment of each CHUNK voxels of the list."""
    N, ncp, P = br.shape
    nchunk = -(-P // CHUNK)
    ca, cr, cc, cs = (_chunked(t, nchunk) for t in (a, br, bc, bs))
    M = N * nchunk
    mom = fit_moment_plain(ca.reshape(M, CHUNK), cr.reshape(M, ncp, CHUNK),
                           cc.reshape(M, ncp, CHUNK),
                           cs.reshape(M, ncp, CHUNK))
    return mom.reshape(N, nchunk, ncp ** 3)


def fit_moment_partial(a, br, bc, bs):
    """K1's first phase: a [N, P]; br/bc/bs [N, ncp, P] -> the per-chunk
    partials [N, ceil(P / CHUNK), ncp^3] float32."""
    N, ncp, P = _check_rows("fit_moment_partial", br, bc, bs)
    if a.shape != (N, P):
        raise ValueError(f"fit_moment_partial: a is {tuple(a.shape)}, "
                         f"expected {(N, P)}")
    check("fit_moment_partial", a, br, bc, bs)
    if not route("fit_moment_partial", a):
        return fit_moment_partial_plain(a, br, bc, bs)
    lib = _lib()
    nchunk = -(-P // CHUNK)
    part = torch.empty((N, nchunk, ncp ** 3), device=a.device,
                       dtype=torch.float32)
    with torch.cuda.device(a.device):
        rc = lib.vj_fit_moment_partial(
            a.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
            part.data_ptr(), N, P, ncp, nchunk, stream(a.device))
    raise_on(rc, "fit_moment_partial")
    LAUNCHES["fit_moment_partial"] += 1
    return part


def _ncp_of(part):
    ncp = round(part.shape[2] ** (1.0 / 3.0))
    if part.dim() != 3 or ncp ** 3 != part.shape[2] or not (
            1 <= ncp <= MAX_NCP):
        raise ValueError(f"fit_moment_reduce: part is {tuple(part.shape)}, "
                         f"expected [N, nchunk, ncp^3] with ncp <= {MAX_NCP}")
    return ncp


def fit_moment_reduce_plain(part):
    """Plain PyTorch version of K1's second phase: the chunks added one
    after another, in chunk order, from 0."""
    N, nchunk, _ = part.shape
    ncp = _ncp_of(part)
    out = torch.zeros((N, ncp ** 3), dtype=part.dtype, device=part.device)
    for c in range(nchunk):
        out = out + part[:, c]
    return out.reshape(N, ncp, ncp * ncp)


def fit_moment_reduce(part):
    """K1's second phase: per-chunk partials [N, nchunk, ncp^3] (one launch's
    or several slabs' concatenated in chunk order) -> [N, ncp, ncp*ncp]."""
    ncp = _ncp_of(part)
    check("fit_moment_reduce", part)
    if not route("fit_moment_reduce", part):
        return fit_moment_reduce_plain(part)
    N, nchunk, _ = part.shape
    out = torch.empty((N, ncp, ncp * ncp), device=part.device,
                      dtype=torch.float32)
    with torch.cuda.device(part.device):
        rc = _lib().vj_fit_moment_reduce(part.data_ptr(), out.data_ptr(), N,
                                         ncp, nchunk, stream(part.device))
    raise_on(rc, "fit_moment_reduce")
    LAUNCHES["fit_moment_reduce"] += 1
    return out


# ---------------------------------------------------------------------------
# The delta shared by K2, K6 and K7.


def _check_phi(name, phi, N, ncp):
    if phi.shape != (N, ncp, ncp * ncp):
        raise ValueError(f"{name}: phi is {tuple(phi.shape)}, expected "
                         f"{(N, ncp, ncp * ncp)}")


def _check_vectors(name, N, P, *vs):
    for t in vs:
        if t.shape != (N, P):
            raise ValueError(f"{name}: vector {tuple(t.shape)}, expected "
                             f"{(N, P)}")


def fit_delta_plain(phi, br, bc, bs):
    """Plain PyTorch version of K6: the raw [N, P] delta = B phi."""
    N, ncp, P = br.shape
    bo = (bc[:, :, None, :] * bs[:, None, :, :]).reshape(N, ncp * ncp, P)
    g = torch.bmm(phi.reshape(N, ncp, ncp * ncp), bo)         # [N, ncp, P]
    return (br * g).sum(1)


def _flush_weight(raw, wv):
    return torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw) * wv


def _conv_sums(d, wv):
    """[N, 2] ITK convergence sums (sum wv e1, sum wv e1^2), e1 = e^-d - 1."""
    e1 = torch.exp(-d) - 1.0
    return torch.stack([(wv * e1).sum(1), (wv * e1 * e1).sum(1)], dim=1)


# ---------------------------------------------------------------------------
# K6: the raw delta.


def fit_delta(phi, br, bc, bs):
    """K6: phi [N, ncp, ncp*ncp]; br/bc/bs [N, ncp, P] power-1 rows ->
    the raw delta [N, P] = sum_c br[c] sum_{d,e} phi[c, d*ncp+e] bc[d]
    bs[e], with no flush and no weight (padded voxels hold whatever their
    rows give)."""
    N, ncp, P = _check_rows("fit_delta", br, bc, bs)
    _check_phi("fit_delta", phi, N, ncp)
    check("fit_delta", phi, br, bc, bs)
    if not route("fit_delta", phi):
        return fit_delta_plain(phi, br, bc, bs)
    lib = _lib()
    nchunk = -(-P // lib.vj_n4_chunk())
    out = torch.empty((N, P), device=phi.device, dtype=torch.float32)
    with torch.cuda.device(phi.device):
        rc = lib.vj_fit_delta(phi.data_ptr(), br.data_ptr(), bc.data_ptr(),
                              bs.data_ptr(), out.data_ptr(), N, P, ncp, nchunk,
                              stream(phi.device))
    raise_on(rc, "fit_delta")
    LAUNCHES["fit_delta"] += 1
    return out


# ---------------------------------------------------------------------------
# K7: the flushed, weighted delta and the convergence sums.


def fit_delta_conv_plain(phi, br, bc, bs, wv):
    """Plain PyTorch version of K7; see ``fit_delta_conv``."""
    d = _flush_weight(fit_delta_plain(phi, br, bc, bs), wv)
    return d, _conv_sums(d, wv)


def fit_delta_conv(phi, br, bc, bs, wv):
    """K7: (d [N, P], stats [N, 2]) with d = delta flushed below 1e-18,
    times wv, and stats = (sum wv (e^-d - 1), sum wv (e^-d - 1)^2): the
    sums from which ITK's convergence test takes the coefficient of
    variation of e^-d over the mask."""
    N, ncp, P = _check_rows("fit_delta_conv", br, bc, bs)
    _check_phi("fit_delta_conv", phi, N, ncp)
    _check_vectors("fit_delta_conv", N, P, wv)
    check("fit_delta_conv", phi, br, bc, bs, wv)
    if not route("fit_delta_conv", wv):
        return fit_delta_conv_plain(phi, br, bc, bs, wv)
    lib = _lib()
    nchunk = -(-P // lib.vj_n4_chunk())
    kw = dict(device=wv.device, dtype=torch.float32)
    d = torch.empty((N, P), **kw)
    part = torch.empty((N, nchunk, 2), **kw)
    stats = torch.empty((N, 2), **kw)
    with torch.cuda.device(wv.device):
        rc = lib.vj_fit_delta_conv(
            phi.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
            wv.data_ptr(), d.data_ptr(), part.data_ptr(),
            _tickets(wv.device, N).data_ptr(), stats.data_ptr(),
            N, P, ncp, nchunk, stream(wv.device))
    raise_on(rc, "fit_delta_conv")
    LAUNCHES["fit_delta_conv"] += 1
    return d, stats


# ---------------------------------------------------------------------------
# K2: fused field update + next residual + convergence sums.


def _field_stats(d, wv, lu):
    """[..., 4] K2 statistics over the last axis: the convergence sums and
    the masked range of lu."""
    e1 = torch.exp(-d) - 1.0
    inf = torch.full_like(lu, float("inf"))
    return torch.stack([(wv * e1).sum(-1), (wv * e1 * e1).sum(-1),
                        torch.where(wv > 0, lu, inf).min(-1).values,
                        torch.where(wv > 0, lu, -inf).max(-1).values], -1)


def fit_delta_conv_field_plain(phi, br, bc, bs, wv, field, logv, done,
                               return_part=False):
    """Plain PyTorch version of K2; see ``fit_delta_conv_field``."""
    d = _flush_weight(fit_delta_plain(phi, br, bc, bs), wv)
    nf = field + (1.0 - done)[:, None] * d
    lu = (logv - nf) * wv
    stats = _field_stats(d, wv, lu)
    if not return_part:
        return nf, lu, stats
    nchunk = -(-wv.shape[1] // CHUNK)
    part = _field_stats(*(_chunked(t, nchunk) for t in (d, wv, lu)))
    return nf, lu, stats, part


def fit_fold_stats_plain(part):
    """Plain PyTorch version of K2's fold: the chunks' statistics folded one
    after another in chunk order (sums from 0, then min and max)."""
    s = torch.tensor([0.0, 0.0, float("inf"), float("-inf")],
                     dtype=part.dtype, device=part.device).expand(
                         part.shape[0], 4)
    for c in range(part.shape[1]):
        p = part[:, c]
        s = torch.stack([s[:, 0] + p[:, 0], s[:, 1] + p[:, 1],
                         torch.minimum(s[:, 2], p[:, 2]),
                         torch.maximum(s[:, 3], p[:, 3])], 1)
    return s


def fit_fold_stats(part):
    """K2's fold on its own: chunk statistics [N, nchunk, 4] (one K2
    launch's or several slabs' concatenated in chunk order) -> [N, 4]."""
    if part.dim() != 3 or part.shape[2] != 4:
        raise ValueError(f"fit_fold_stats: part is {tuple(part.shape)}, "
                         f"expected [N, nchunk, 4]")
    check("fit_fold_stats", part)
    if not route("fit_fold_stats", part):
        return fit_fold_stats_plain(part)
    N, nchunk, _ = part.shape
    stats = torch.empty((N, 4), device=part.device, dtype=torch.float32)
    with torch.cuda.device(part.device):
        rc = _lib().vj_fit_fold_stats(part.data_ptr(), stats.data_ptr(), N,
                                      nchunk, stream(part.device))
    raise_on(rc, "fit_fold_stats")
    LAUNCHES["fit_fold_stats"] += 1
    return stats


def fit_delta_conv_field(phi, br, bc, bs, wv, field, logv, done,
                         return_part=False):
    """K2: one N4 iteration tail for every lane.

    phi [N, ncp, ncp*ncp] coefficients; br/bc/bs [N, ncp, P] power-1 rows;
    wv/field/logv [N, P]; done [N] float (1.0 = lane converged, frozen).
    Returns (field' [N, P], logu' [N, P], stats [N, 4]) with
    field' = field + (1 - done) * delta, logu' = (logv - field') * wv and
    stats = (sum wv*(e^-delta - 1), sum wv*(e^-delta - 1)^2,
    masked min logu', masked max logu').  ``return_part`` also returns
    the per-chunk statistics [N, ceil(P / CHUNK), 4] that stats folds.
    """
    N, ncp, P = _check_rows("fit_delta_conv_field", br, bc, bs)
    _check_phi("fit_delta_conv_field", phi, N, ncp)
    _check_vectors("fit_delta_conv_field", N, P, wv, field, logv)
    if done.shape != (N,):
        raise ValueError(f"fit_delta_conv_field: done is {tuple(done.shape)}")
    check("fit_delta_conv_field", phi, br, bc, bs, wv, field, logv, done)
    if not route("fit_delta_conv_field", wv):
        return fit_delta_conv_field_plain(phi, br, bc, bs, wv, field, logv,
                                          done, return_part)
    lib = _lib()
    nchunk = -(-P // lib.vj_n4_chunk())
    kw = dict(device=wv.device, dtype=torch.float32)
    nf = torch.empty((N, P), **kw)
    lu = torch.empty((N, P), **kw)
    part = torch.empty((N, nchunk, 4), **kw)
    stats = torch.empty((N, 4), **kw)
    with torch.cuda.device(wv.device):
        rc = lib.vj_fit_delta_conv_field(
            phi.data_ptr(), br.data_ptr(), bc.data_ptr(), bs.data_ptr(),
            wv.data_ptr(), field.data_ptr(), logv.data_ptr(), done.data_ptr(),
            nf.data_ptr(), lu.data_ptr(), part.data_ptr(),
            _tickets(wv.device, N).data_ptr(), stats.data_ptr(),
            N, P, ncp, nchunk, stream(wv.device))
    raise_on(rc, "fit_delta_conv_field")
    LAUNCHES["fit_delta_conv_field"] += 1
    return (nf, lu, stats, part) if return_part else (nf, lu, stats)
