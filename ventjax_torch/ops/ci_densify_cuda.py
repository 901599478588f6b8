"""The CI map's rank-densify kernels K9 and K8: CUDA wrappers and plain
versions.

Counterpart of the dense-map half of ``ventjax/ops/ci_pallas.py``.  The CI
values ``cv`` [N, k] of each lane's first k defect voxels (row-major order)
become the dense [N, V] map by the rank identity

    dense[v] = cv[rank[v]] where d01[v] and rank[v] < k, else 0,
    rank = cumsum(d01) - 1,

which equals the scatter of ``cv`` to the compacted defect indices (they
ascend), including its ``mode="drop"`` for defect voxels past the pad.

- ``rank`` (K9, ``csrc/ci_densify.cu``; replaces ``rank_pallas``): int32
  inclusive count minus one, per lane.
- ``densify_rank`` (K8; replaces ``densify_rank_pallas``): the lookup.

Both are exact: each kernel and its plain version agree bit for bit, and
both take any V (the kernels mask their own ragged edge).  Each wrapper runs
its plain version for a CPU tensor, launches its kernel for a CUDA tensor,
and raises for anything else.
"""
from __future__ import annotations

import ctypes

import torch

from ventjax_torch import _build
from ventjax_torch.ops._launch import check, raise_on, route, stream

# Kernel launches per wrapper since the counts were last set to 0.
LAUNCHES = {"rank": 0, "densify_rank": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("ci_densify")
    if not getattr(lib, "_vj_typed", False):
        lib.vj_rank_tile.argtypes = []
        lib.vj_rank_tile.restype = _I
        lib.vj_rank.argtypes = [_P] * 3 + [_I] * 3 + [_P]
        lib.vj_rank.restype = _I
        lib.vj_densify_rank.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.vj_densify_rank.restype = _I
        lib._vj_typed = True
    return lib


def _check_d01(name, d01):
    if d01.dim() != 2 or d01.dtype != torch.bool:
        raise TypeError(f"{name}: d01 must be a [N, V] bool tensor, got "
                        f"{tuple(d01.shape)} {d01.dtype}")
    return d01.shape


# ---------------------------------------------------------------------------
# K9: rank = cumsum - 1.


def rank_plain(d01):
    """Plain PyTorch version of K9: [N, V] int32."""
    return torch.cumsum(d01, 1, dtype=torch.int32) - 1


def rank(d01):
    """K9: d01 [N, V] bool -> rank [N, V] int32 = cumsum(d01) - 1."""
    N, V = _check_d01("rank", d01)
    check("rank", d01, dtype=torch.bool)
    if not route("rank", d01):
        return rank_plain(d01)
    lib = _lib()
    ntile = -(-V // lib.vj_rank_tile())
    counts = torch.empty((N, ntile), dtype=torch.int32, device=d01.device)
    out = torch.empty((N, V), dtype=torch.int32, device=d01.device)
    rc = lib.vj_rank(d01.data_ptr(), counts.data_ptr(), out.data_ptr(), N, V,
                     ntile, stream(d01.device))
    raise_on(rc, "rank")
    LAUNCHES["rank"] += 1
    return out


# ---------------------------------------------------------------------------
# K8: dense map from the ranks.


def densify_rank_plain(rank, d01, cv, k):
    """Plain PyTorch version of K8: [N, V] float32."""
    keep = d01 & (rank >= 0) & (rank < k)
    vals = cv.gather(1, rank.clamp(0, k - 1).to(torch.int64))
    return torch.where(keep, vals, torch.zeros_like(vals))


def densify_rank(rank, d01, cv, k):
    """K8: rank [N, V] int32, d01 [N, V] bool, cv [N, k] float32, k >= 1 ->
    [N, V] float32: cv[rank] where d01 and rank < k, else 0."""
    N, V = _check_d01("densify_rank", d01)
    if rank.shape != (N, V) or rank.dtype != torch.int32:
        raise TypeError(f"densify_rank: rank must be [{N}, {V}] int32, got "
                        f"{tuple(rank.shape)} {rank.dtype}")
    if k < 1 or cv.shape != (N, k) or cv.dtype != torch.float32:
        raise TypeError(f"densify_rank: cv must be [{N}, {k}] float32, got "
                        f"{tuple(cv.shape)} {cv.dtype}")
    check("densify_rank", rank, dtype=torch.int32)
    check("densify_rank", d01, dtype=torch.bool)
    check("densify_rank", cv)
    if not rank.device == d01.device == cv.device:
        raise ValueError(f"densify_rank: tensors on {rank.device}, "
                         f"{d01.device} and {cv.device}")
    if not route("densify_rank", d01):
        return densify_rank_plain(rank, d01, cv, k)
    out = torch.empty((N, V), dtype=torch.float32, device=d01.device)
    rc = _lib().vj_densify_rank(rank.data_ptr(), d01.data_ptr(),
                                cv.data_ptr(), out.data_ptr(), N, V, k,
                                stream(d01.device))
    raise_on(rc, "densify_rank")
    LAUNCHES["densify_rank"] += 1
    return out
