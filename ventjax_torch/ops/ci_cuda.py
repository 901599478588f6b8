"""The CI head-phase kernel K3: CUDA wrapper and plain version.

Counterpart of ``ventjax/ops/ci_pallas.py:head_counts_pallas``.  For every
center (a defect voxel) of every lane, and each of the first ``ns`` balls,
count the witnesses w with ``dmin2(center, w) <= r2[j]``, where dmin2 is
the smallest scaled squared distance over the alias combos (the reference's
linear-index wraparound, or the plain offset in "pad" mode) whose offset lies
in the rmax box.  Distances are float32 computed unfused as
``((fx*fx) + (fy*fy)) + (fz*fz)`` with ``fx = float(oi) * s0``: the
arithmetic that the geometry's build-time proof validates.

Counts are exact integers: the kernel (``csrc/ci_head.cu``) and the plain
version must agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream

MAX_NS = 128
MAX_COMBOS = 9
PLAIN_ROWS = 256   # centers per block of the plain version's [N, rows, Kw]
# Kernel launches since the count was last set to 0.
LAUNCHES = {"head_counts": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = _build.load("ci_head")
    if not getattr(lib, "_vj_typed", False):
        lib.vj_head_counts.argtypes = (
            [_P] * 8 + [_I] * 4 + [_P, _I] + [_F] * 3 + [_I, _P])
        lib.vj_head_counts.restype = _I
        lib._vj_typed = True
    return lib


def alias_min_d2(centers, witnesses, combos, scale, rmax):
    """[N, rows, Kw] float32 min-over-alias squared distances (+inf where
    no combo puts the offset inside the rmax box).  centers/witnesses are
    triples of [N, rows] / [N, Kw] int32 coordinates."""
    vi, vj, vk = (c[:, :, None] for c in centers)
    wi, wj, wk = (w[:, None, :] for w in witnesses)
    s0, s1, s2 = scale
    dmin2 = None
    for (p, q, s) in combos:
        oi = (wi - vi) + p
        oj = (wj - vj) + q
        ok = (wk - vk) + s
        inbox = (oi.abs() <= rmax) & (oj.abs() <= rmax) & (ok.abs() <= rmax)
        fx = oi.to(torch.float32) * s0
        fy = oj.to(torch.float32) * s1
        fz = ok.to(torch.float32) * s2
        d2 = fx * fx + fy * fy + fz * fz
        d2 = torch.where(inbox, d2, torch.full_like(d2, float("inf")))
        dmin2 = d2 if dmin2 is None else torch.minimum(dmin2, d2)
    return dmin2


def head_counts_plain(centers, witnesses, r2, combos, scale, rmax):
    """Plain PyTorch version of K3: [N, K, ns] int32 counts."""
    N, K = centers[0].shape
    ns = r2.shape[0]
    out = torch.empty((N, K, ns), dtype=torch.int32, device=r2.device)
    for a in range(0, K, PLAIN_ROWS):
        cc = tuple(c[:, a:a + PLAIN_ROWS] for c in centers)
        dmin2 = alias_min_d2(cc, witnesses, combos, scale, rmax)
        # first ball that holds each witness; ns = in none of the first ns
        first = torch.searchsorted(r2, dmin2.contiguous(), right=False)
        hist = torch.zeros((N, dmin2.shape[1], ns + 1), dtype=torch.int32,
                           device=r2.device)
        hist.scatter_add_(2, first.clamp(max=ns),
                          torch.ones_like(first, dtype=torch.int32))
        out[:, a:a + PLAIN_ROWS] = hist[:, :, :ns].cumsum(2, dtype=torch.int32)
    return out


def head_counts(
    centers: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    witnesses: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    r2: torch.Tensor,
    combos: Sequence[Tuple[int, int, int]],
    scale: Tuple[float, float, float],
    rmax: int,
) -> torch.Tensor:
    """K3: [N, K, ns] int32 counts of witnesses within each of the first
    ns balls (r2 [ns] float32, ascending) of each center.

    centers: three [N, K] int32 coordinate tensors; witnesses: three
    [N, Kw] int32.  Sentinel rows (far-away coordinates) are allowed.
    """
    ns = r2.shape[0]
    if not 1 <= ns <= MAX_NS:
        raise ValueError(f"head_counts: ns={ns} outside 1..{MAX_NS}")
    if not 1 <= len(combos) <= MAX_COMBOS:
        raise ValueError(f"head_counts: {len(combos)} alias combos")
    N, K = centers[0].shape
    Kw = witnesses[0].shape[1]
    for c in centers:
        if c.shape != (N, K):
            raise ValueError(f"head_counts: center shape {tuple(c.shape)}")
    for w in witnesses:
        if w.shape != (N, Kw):
            raise ValueError(f"head_counts: witness shape {tuple(w.shape)}")
    check("head_counts", *centers, *witnesses, dtype=torch.int32)
    check("head_counts", r2)
    dev = r2.device
    if centers[0].device != dev:
        raise ValueError(f"head_counts: tensors on {centers[0].device} and "
                         f"{dev}")
    if not route("head_counts", r2):
        return head_counts_plain(centers, witnesses, r2, combos, scale, rmax)
    lib = _lib()
    out = torch.empty((N, K, ns), dtype=torch.int32, device=dev)
    flat = [int(v) for pqs in combos for v in pqs]
    combo_arr = (ctypes.c_int * len(flat))(*flat)
    rc = lib.vj_head_counts(
        *(t.data_ptr() for t in (*centers, *witnesses)),
        r2.data_ptr(), out.data_ptr(), N, K, Kw, ns,
        ctypes.cast(combo_arr, ctypes.c_void_p), len(combos),
        *(float(s) for s in scale), int(rmax), stream(dev))
    raise_on(rc, "head_counts")
    LAUNCHES["head_counts"] += 1
    return out
