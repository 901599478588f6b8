"""CI module compatibility surface (the reference's CI.py public API).

Counterpart of ``ventjax/compat/ci_module.py``.  ``calculate_CI(defectArray,
vox, Rmax, type)`` returns the CI map the reference's thread-pool sphere
growing produces (CI.py:107-145), computed on the device by the pairwise
engine (kernel K3 on a card) or, where ``build_geometry`` gives the gather
ladder's geometry, by the ladder; with ``config.ci_shard_slices > 1``, by
the slice-sharded engine of ``dist/halo.py``.  The helper functions (multi_which,
px2vec, vec2px, getSpherePix, getRadiiIndices, calculate_CV) are NumPy, for
users who called them directly.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ventjax_torch.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.ops.ci import calculate_ci as _ladder
from ventjax_torch.ops.ci_pairwise import (
    CIPairwiseGeometry, calculate_ci_pairwise,
)
from ventjax_torch.oracle import ci_oracle
from ventjax_torch.pipeline.analyze import build_geometry
from ventjax_torch.utils.device import resolve_device


def multi_which(A):
    """Indices of nonzero voxels, rows of [i, j, k] (CI.py:10-30)."""
    if np.isscalar(A):
        return np.where(A)[0]
    return np.argwhere(np.asarray(A))


def px2vec(i, j, k, arrayShape):
    """Linear index map incl. the reference's 1-offset (CI.py:65-68)."""
    return i + (j - 1) * arrayShape[0] + (k - 1) * arrayShape[0] * arrayShape[1]


def vec2px(n, arrayShape):
    """Inverse of px2vec (CI.py:70-77)."""
    s = np.ceil(n / (arrayShape[0] * arrayShape[1]))
    n = n - (s - 1) * arrayShape[1] * arrayShape[0]
    c = np.ceil(n / arrayShape[0])
    r = n - (c - 1) * arrayShape[0]
    return int(r), int(c), int(s)


def getSpherePix(vox, radius):
    """Nx4 [r, di, dj, dk] shell table (CI.py:33-63), built in memory — no
    .npy cwd cache; bit-identical to the reference artifacts."""
    return ci_oracle.sphere_pixels(vox, radius)


def getRadiiIndices(data):
    """Row indices where a new radius starts (CI.py:79-85)."""
    diffs = np.diff(data[:, 0]) > 0
    return np.where(diffs)[0] + 1


def calculate_CV(defectArrayShape, activeVoxel, defVec, spherePx):
    """Single-voxel CV (CI.py:87-105): the radius of the largest sphere
    centered at activeVoxel whose defect fraction stays >= 0.5.

    Returns np.append(activeVoxel, radius) in scaled-voxel units (the
    caller applies the min(vox) mm scaling, CI.py:142), and raises
    ValueError when even the Rmax sphere stays >= 50% defect — exactly the
    reference's contract, including its intersect1d uniqueness semantics
    (duplicate border-aliased indices count once in the numerator, raw
    prefix row count in the denominator).

    One first-occurrence scan gives the cumulative unique-defect count at
    every prefix length, so all radii are tested in one pass (the
    reference loops intersect1d per radius).
    """
    activeVoxel = np.asarray(activeVoxel)
    sphereRads = getRadiiIndices(spherePx)
    sphereVec = px2vec(
        spherePx[:, 1] + activeVoxel[0],
        spherePx[:, 2] + activeVoxel[1],
        spherePx[:, 3] + activeVoxel[2],
        defectArrayShape,
    )
    uniq, first_idx = np.unique(sphereVec, return_index=True)
    hits = first_idx[np.isin(uniq, defVec)]
    # cum[L] = |unique(sphereVec[:L]) ∩ defVec|, via first occurrences
    cum = np.zeros(len(sphereVec) + 1, np.int64)
    np.add.at(cum, hits + 1, 1)
    cum = np.cumsum(cum)
    for ii in sphereRads:
        if cum[ii] / ii < 0.5:
            return np.append(activeVoxel, spherePx[ii - 1, 0])
    logging.critical(f"--MAX RADIUS of {spherePx[-1, 0]} REACHED--")
    raise ValueError(
        f"sphere at {tuple(activeVoxel)} stayed >=50% defect out to Rmax "
        f"({spherePx[-1, 0]}); the reference raises here too (CI.py:101-104)"
    )


def defect_pad(defectArray) -> int:
    """The CI defect pad of a study: the smallest power of two >= 256 that
    holds every defect voxel of ``defectArray``."""
    n_def = int((np.asarray(defectArray) != 0).sum())
    return max(256, 1 << int(np.ceil(np.log2(max(n_def, 1)))))


def calculate_CI(
    defectArray,
    vox=(1, 1, 1),
    Rmax: int = 50,
    type: str = "fast",  # noqa: A002 — reference keyword
    config: Optional[VentConfig] = None,
    device="cuda",
):
    """CI map in mm, float64 on the host (CI.py:107-145 'fast' semantics),
    computed on ``device``: the CUDA card unless ``device="cpu"``.

    The 'slow'/'fast' distinction of the reference is moot (both were the
    same math).  The defect pad is ``defect_pad(defectArray)``; a tail
    overflow of the pairwise engine is retried once with a full-width tail
    (``tail_k = pad``), so the map is exact, never saturated by the pad.
    With ``config.ci_shard_slices > 1`` the map is slice-sharded over that
    many of ``device``'s local devices (``dist.calculate_ci_sharded``,
    bit-identical), with the same retry; a geometry that cannot shard
    raises a ValueError saying why.
    """
    cfg = config or DEFAULT_CONFIG
    dev = resolve_device(device)
    defect = np.asarray(defectArray)
    geom = build_geometry(
        tuple(float(v) for v in vox),
        defect.shape,
        cfg.replace(ci_rmax=int(Rmax)),
    )
    k = defect_pad(defect)
    d = torch.from_numpy(defect.astype(np.float32))[None].to(dev)
    if cfg.ci_shard_slices and cfg.ci_shard_slices > 1:
        from ventjax_torch.dist.halo import calculate_ci_sharded

        ci_map, _, ovf = calculate_ci_sharded(
            d[0], geom, n_shards=cfg.ci_shard_slices, max_defect_voxels=k)
        if bool(ovf):
            # k >= n_def rules out a center overflow, so the flag means the
            # per-shard tail budget (k // 8) or a halo message (k // 2 a
            # side) overflowed; at full width (tail_k = halo_pad = k) no
            # cause remains.
            ci_map, _, ovf = calculate_ci_sharded(
                d[0], geom, n_shards=cfg.ci_shard_slices,
                max_defect_voxels=k, tail_k=k, halo_pad=k)
            if bool(ovf):   # unreachable by construction; never silent
                raise RuntimeError(
                    "sharded CI still overflowed at full-width budgets — "
                    "please report this geometry")
        return ci_map.cpu().numpy().astype(np.float64)
    if isinstance(geom, CIPairwiseGeometry):
        ci_map, _, ovf = calculate_ci_pairwise(d, geom, max_defect_voxels=k)
        if bool(ovf[0]):
            # k >= n_def leaves the tail budget as the only overflow cause
            ci_map, _, _ = calculate_ci_pairwise(
                d, geom, max_defect_voxels=k, tail_k=k)
    else:
        ci_map, _, _ = _ladder(d, geom, max_defect_voxels=k)
    return ci_map[0].cpu().numpy().astype(np.float64)
