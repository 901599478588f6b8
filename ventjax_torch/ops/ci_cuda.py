"""The CI kernels K3 (head counts) and K10 (tail balls): CUDA wrappers and
plain versions.

K3 is the counterpart of ``ventjax/ops/ci_pallas.py:head_counts_pallas``.
For every center (a defect voxel) of every lane, and each of the first
``ns`` balls, count the witnesses w with ``dmin2(center, w) <= r2[j]``,
where dmin2 is the smallest scaled squared distance over the alias combos
(the reference's linear-index wraparound, or the plain offset in "pad"
mode) whose offset lies in the rmax box.  Distances are float32 computed
unfused as
``((fx*fx) + (fy*fy)) + (fz*fz)`` with ``fx = float(oi) * s0``: the
arithmetic that the geometry's build-time proof validates.

K10 has no Pallas counterpart: ventjax finishes the tail rows with a sort
of their [N, rows, Kw] distances, and K10's plain version is that sort.
For each tail row it gives the first ball j with fewer than T[j] witnesses
inside it, from per-row shell counts.

Counts and ball indices are exact integers: the kernels
(``csrc/ci_head.cu``) and the plain versions must agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream

MAX_NS = 128
MAX_COMBOS = 9
PLAIN_ROWS = 256   # centers per block of the plain versions' [N, rows, Kw]
# The CI kernels' launches and the rows they ran, since each count was last
# set to 0: K3's launches; the [N, K] centre rows the K3 wrapper was entered
# with (either route), and its (centre, witness, alias combo) triples,
# N x K x Kw x combos, the quadratic work it was handed; K10's launches; the
# [N, rows] tail rows the K10 wrapper was entered with (either route).
# That last count keeps the name of the distance pass that ran the tail
# before K10 (``alias_min_d2``), because the benchmark's ``ci_row_use``
# reads it by that name.  Python ints: counting reads nothing from the
# device.
LAUNCHES = {"head_counts": 0, "head_counts_rows": 0, "head_counts_triples": 0,
            "alias_min_d2_rows": 0, "tail_balls": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _typed(lib):
    """lib with the C signature of csrc/ci_head.cu set."""
    if not getattr(lib, "_vj_typed", False):
        lib.vj_head_counts.argtypes = (
            [_P] * 8 + [_I] * 4 + [_P, _I] + [_F] * 3 + [_I, _P])
        lib.vj_head_counts.restype = _I
        lib.vj_tail_balls.argtypes = (
            [_P] * 9 + [_I] * 4 + [_P, _I] + [_F] * 3 + [_I, _P])
        lib.vj_tail_balls.restype = _I
        lib._vj_typed = True
    return lib


def _lib():
    return _typed(_build.load("ci_head"))


def _alias_min_d2(centers, witnesses, combos, scale, rmax):
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
        dmin2 = _alias_min_d2(cc, witnesses, combos, scale, rmax)
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
    if len(combos) not in (1, MAX_COMBOS):
        raise ValueError(f"head_counts: {len(combos)} alias combos, not 1 "
                         f"(pad) or {MAX_COMBOS} (wrap)")
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
    LAUNCHES["head_counts_rows"] += N * K
    LAUNCHES["head_counts_triples"] += N * K * Kw * len(combos)
    if not route("head_counts", r2):
        return head_counts_plain(centers, witnesses, r2, combos, scale, rmax)
    lib = _lib()
    out = torch.empty((N, K, ns), dtype=torch.int32, device=dev)
    flat = [int(v) for pqs in combos for v in pqs]
    combo_arr = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(dev):
        rc = lib.vj_head_counts(
            *(t.data_ptr() for t in (*centers, *witnesses)),
            r2.data_ptr(), out.data_ptr(), N, K, Kw, ns,
            ctypes.cast(combo_arr, ctypes.c_void_p), len(combos),
            *(float(s) for s in scale), int(rmax), stream(dev))
    raise_on(rc, "head_counts")
    LAUNCHES["head_counts"] += 1
    return out


def _order_tables(r2, T, nw):
    """(thr [nw], j_lo [nw], j_cap) of the sort test, as numpy: ball j is
    probed at sorted position T[j] - 1; thr holds the r2 of the first ball
    probed at each position (+inf where none is) and j_lo that ball; j_cap
    is the first ball probed past the row's nw witnesses (always failing),
    else nb."""
    r2 = r2.cpu().numpy()
    t_idx = T.cpu().numpy().astype(np.int64) - 1
    nb = len(r2)
    thr = np.full(nw, np.inf, np.float32)
    j_lo = np.full(nw, nb, np.int64)
    for j in range(nb - 1, -1, -1):
        t = t_idx[j]
        if t < nw:
            thr[t] = r2[j]
            j_lo[t] = j
    over = np.flatnonzero(t_idx >= nw)
    return thr, j_lo, int(over[0]) if len(over) else nb


def tail_balls_plain(centers, witnesses, r2, T, combos, scale, rmax):
    """Plain PyTorch version of K10, by full order statistics: each row's
    sorted distances against the static thresholds of ``_order_tables``.
    [N, rows] int64 (on a card it reads its tables back, a host wait)."""
    N, K = centers[0].shape
    nb = r2.shape[0]
    thr, j_lo, j_cap = _order_tables(r2, T, witnesses[0].shape[1])
    thr = torch.from_numpy(thr).to(r2.device)
    j_lo = torch.from_numpy(j_lo).to(r2.device)
    out = torch.empty((N, K), dtype=torch.int64, device=r2.device)
    for a in range(0, K, PLAIN_ROWS):
        cc = tuple(c[:, a:a + PLAIN_ROWS] for c in centers)
        srt = torch.sort(_alias_min_d2(cc, witnesses, combos, scale, rmax),
                         dim=2).values
        failing = srt > thr
        any_f = failing.any(2)
        tstar = failing.to(torch.uint8).argmax(2)
        j = torch.where(any_f, j_lo[tstar], torch.full_like(tstar, nb))
        out[:, a:a + PLAIN_ROWS] = j.clamp(max=j_cap)
    return out


def tail_balls(
    centers: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    witnesses: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    r2: torch.Tensor,
    T: torch.Tensor,
    combos: Sequence[Tuple[int, int, int]],
    scale: Tuple[float, float, float],
    rmax: int,
) -> torch.Tensor:
    """K10: [N, rows] int64, for each center the first ball j < nb with
    #{ w : dmin2(center, w) <= r2[j] } < T[j], or nb where there is none.

    centers: three [N, rows] int32 coordinate tensors; witnesses: three
    [N, Kw] int32; r2 [nb] float32 ascending, T [nb] int32 nondecreasing
    (the geometry's tables up to its j_cap).  Sentinel rows are allowed.
    Counts N x rows in ``LAUNCHES["alias_min_d2_rows"]`` on either route.
    """
    if len(combos) not in (1, MAX_COMBOS):
        raise ValueError(f"tail_balls: {len(combos)} alias combos, not 1 "
                         f"(pad) or {MAX_COMBOS} (wrap)")
    N, R = centers[0].shape
    Kw = witnesses[0].shape[1]
    nb = r2.shape[0]
    if not 1 <= N <= 65535 or R < 1 or Kw < 1:
        raise ValueError(f"tail_balls: N={N}, rows={R}, Kw={Kw}")
    for c in centers:
        if c.shape != (N, R):
            raise ValueError(f"tail_balls: center shape {tuple(c.shape)}")
    for w in witnesses:
        if w.shape != (N, Kw):
            raise ValueError(f"tail_balls: witness shape {tuple(w.shape)}")
    if r2.dim() != 1 or T.shape != (nb,):
        raise ValueError(f"tail_balls: r2 {tuple(r2.shape)} and T "
                         f"{tuple(T.shape)} are not one [nb] pair")
    check("tail_balls", *centers, *witnesses, T, dtype=torch.int32)
    check("tail_balls", r2)
    dev = r2.device
    if centers[0].device != dev:
        raise ValueError(f"tail_balls: tensors on {centers[0].device} and "
                         f"{dev}")
    LAUNCHES["alias_min_d2_rows"] += N * R
    if not route("tail_balls", r2):
        return tail_balls_plain(centers, witnesses, r2, T, combos, scale,
                                rmax)
    lib = _lib()
    out = torch.empty((N, R), dtype=torch.int64, device=dev)
    flat = [int(v) for pqs in combos for v in pqs]
    combo_arr = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(dev):
        rc = lib.vj_tail_balls(
            *(t.data_ptr() for t in (*centers, *witnesses)),
            r2.data_ptr(), T.data_ptr(), out.data_ptr(), N, R, Kw, nb,
            ctypes.cast(combo_arr, ctypes.c_void_p), len(combos),
            *(float(s) for s in scale), int(rmax), stream(dev))
    raise_on(rc, "tail_balls")
    LAUNCHES["tail_balls"] += 1
    return out
