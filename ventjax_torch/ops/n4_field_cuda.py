"""N4's dense bias field in one fixed-order kernel: CUDA wrapper and plain
version.

``n4_field`` (``csrc/n4_field.cu``) evaluates every level's B-spline
lattice on the full [H, W, D] grid and sums the levels:
``field[n, h, w, s] = sum_L sum_c th_L[h, c] sum_d tw_L[w, d] sum_e
ts_L[s, e] phi_L[n, c, d*ncp + e]``.  ventjax computes this with an einsum
outside any kernel (``ventjax/ops/n4.py:500-512``); it has no Pallas
counterpart.  The port gives it a kernel of its own so that the sum runs
in one written order per voxel: a lane's field then has the same bits
whatever batch it runs in, which three batched GEMMs a level
(``n4_field_bmm``, kept as the yardstick) did not give on the card (a
batch of one rounded another way).

Each 1-D basis row has at most four non-zero columns (``span`` .. ``span +
3``), so the tables hold a span and four weights per axis position
(``field_tables``).  The plain version runs the same float32 products and
sums in the same order as the kernel (each inner sum once per (c, d, s)
and (c, w, s), where the kernel's threads recompute the ones they share,
which gives the same values), so the kernel is bit-equal to it.

A slab of the volume (``rows=(r0, r1)``, the space axis) takes the same
kernel with the h part of the tables cut to its rows and H replaced by
the slab height: each voxel is summed alone, and its f(c, w, s) column
sums do not depend on h, so the slab's rows equal the full field's rows
bit for bit.

The wrapper runs the plain version for a CPU tensor, launches the kernel
for a CUDA tensor, and raises for anything else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream
from ventjax_torch.ops.geometry import (
    bspline_basis_1d, bspline_span_weights,
)
from ventjax_torch.utils.profiling import host_wait

MAX_LEVELS = 8   # the kernel's Levels table (csrc/n4_field.cu)
MAX_NCP = 400    # its f columns in shared memory (csrc/n4_field.cu)
# Kernel launches since the count was last set to 0.
LAUNCHES = {"n4_field": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _typed(lib):
    """lib with the C signatures of csrc/n4_field.cu set."""
    if not getattr(lib, "_vj_typed", False):
        lib.vj_n4_field.argtypes = [_P] * 4 + [_I] * 5 + [_P, _I, _P]
        lib.vj_n4_field.restype = _I
        lib._vj_typed = True
    return lib


def _lib():
    return _typed(_build.load("n4_field"))


# The tables of each (shape, ncps, device) once built; never written.
_TABLES = {}


def field_tables(shape, ncps, device, rows=None):
    """(spans int32 [L, h+W+D], weights float32 [L, h+W+D, 4]) on device:
    each level's basis rows along h (the rows r0..r1 - 1 of
    ``rows=(r0, r1)``, default all H), then w, then s."""
    r0, r1 = (0, shape[0]) if rows is None else rows
    key = (tuple(shape), tuple(ncps), str(torch.device(device)), r0, r1)
    if key not in _TABLES:
        def cut(p, axis):
            return (p[0][r0:r1], p[1][r0:r1]) if axis == 0 else p

        parts = [[cut(bspline_span_weights(n, ncp - 3), axis)
                  for axis, n in enumerate(shape)]
                 for ncp in ncps]
        spans = np.stack([np.concatenate([p[0] for p in lv])
                          for lv in parts]).astype(np.int32)
        weights = np.stack([np.concatenate([p[1] for p in lv])
                            for lv in parts]).astype(np.float32)
        with host_wait("n4.field.sync"):    # once a key: pageable copies
            _TABLES[key] = (torch.from_numpy(spans).to(device),
                            torch.from_numpy(weights).to(device))
    return _TABLES[key]


def _contract(acc, idx, wts, dim):
    """sum_j wts[:, j] * acc.index_select(dim, idx[:, j]), added left to
    right from j = 0 with no leading zero; wts broadcast along dim."""
    shape = [1] * acc.dim()
    shape[dim] = -1
    out = None
    for j in range(4):
        t = acc.index_select(dim, idx[:, j]) * wts[:, j].reshape(shape)
        out = t if out is None else out + t
    return out


def _rows(shape, rows):
    H = int(shape[0])
    r0, r1 = (0, H) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= H:
        raise ValueError(f"n4_field: rows {rows} outside 0..{H}")
    return (r0, r1)


def n4_field_plain(phi, shape, ncps, rows=None):
    """Plain PyTorch version of ``n4_field``: the same float32 operations
    in the same order."""
    N = phi.shape[0]
    r0, r1 = _rows(shape, rows)
    _, W, D = shape
    H = r1 - r0
    spans, weights = field_tables(shape, ncps, phi.device, (r0, r1))
    four = torch.arange(4, device=phi.device)
    field, off = None, 0
    for L, ncp in enumerate(ncps):
        lat = phi[:, off:off + ncp ** 3].reshape(N, ncp, ncp, ncp)
        off += ncp ** 3
        sp = spans[L].long()
        idx = sp[:, None] + four                      # [H+W+D, 4]
        wt = weights[L]
        ih, iw, is_ = idx[:H], idx[H:H + W], idx[H + W:]
        wh, ww, ws = wt[:H], wt[H:H + W], wt[H + W:]
        g = _contract(lat, is_, ws, 3)                # [N, c, d, s]
        f = _contract(g, iw, ww, 2)                   # [N, c, w, s]
        lvl = _contract(f, ih, wh, 1)                 # [N, h, w, s]
        field = lvl if field is None else field + lvl
    return field


def n4_field_bmm(phi, shape, ncps):
    """The dense field as three batched GEMMs a level over the dense
    bspline_basis_1d tables (12 ``torch.bmm`` at four levels): the
    evaluation the kernel replaced, whose rounding follows the batch.  No
    path runs it; it is the yardstick the kernel is timed and held
    against."""
    N = phi.shape[0]
    H, W, D = shape
    total, off = None, 0
    for ncp in ncps:
        p = phi[:, off:off + ncp ** 3].reshape(N, ncp, ncp * ncp)
        off += ncp ** 3
        th, tw, ts = (torch.as_tensor(bspline_basis_1d(n, ncp - 3),
                                      dtype=torch.float32,
                                      device=phi.device).expand(N, n, ncp)
                      for n in shape)
        t = torch.bmm(th, p).reshape(N, H, ncp, ncp).transpose(1, 2)
        t = torch.bmm(tw, t.reshape(N, ncp, H * ncp))
        t = torch.bmm(t.reshape(N, W * H, ncp), ts.transpose(1, 2))
        t = t.reshape(N, W, H, D).transpose(1, 2)
        total = t if total is None else total + t
    return total


def n4_field(phi, shape, ncps, rows=None):
    """Dense N4 field [N, H, W, D] from the per-level lattices.

    phi [N, sum ncp^3] float32, contiguous: each lane's lattices in level
    order, each [ncp, ncp, ncp] as (c, d, e) over (h, w, s); shape (H, W,
    D); ncps each level's control points per axis (4 .. MAX_NCP).  With
    ``rows=(r0, r1)`` only those rows of the field, [N, r1 - r0, W, D]."""
    shape = tuple(int(x) for x in shape)
    r0, r1 = _rows(shape, rows)
    _, W, D = shape
    H = r1 - r0
    ncps = tuple(int(c) for c in ncps)
    if phi.dim() != 2 or phi.shape[1] != sum(c ** 3 for c in ncps):
        raise ValueError(f"n4_field: phi is {tuple(phi.shape)}, expected "
                         f"[N, {sum(c ** 3 for c in ncps)}] for ncps {ncps}")
    if not (1 <= len(ncps) <= MAX_LEVELS
            and 4 <= min(ncps) <= max(ncps) <= MAX_NCP):
        raise ValueError(f"n4_field: 1..{MAX_LEVELS} levels of 4 <= ncp <= "
                         f"{MAX_NCP} each, got {ncps}")
    check("n4_field", phi)
    if not route("n4_field", phi):
        return n4_field_plain(phi, shape, ncps, (r0, r1))
    lib = _lib()
    N = phi.shape[0]
    spans, weights = field_tables(shape, ncps, phi.device, (r0, r1))
    out = torch.empty((N, H, W, D), device=phi.device, dtype=torch.float32)
    c_ncps = (ctypes.c_int * len(ncps))(*ncps)
    with torch.cuda.device(phi.device):
        rc = lib.vj_n4_field(phi.data_ptr(), spans.data_ptr(),
                             weights.data_ptr(), out.data_ptr(), N, H, W, D,
                             len(ncps), ctypes.cast(c_ncps, _P), phi.shape[1],
                             stream(phi.device))
    raise_on(rc, "n4_field")
    LAUNCHES["n4_field"] += 1
    return out
