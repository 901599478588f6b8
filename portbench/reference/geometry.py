"""Host tables of the plain reference (NumPy, float64).

A frozen copy of the tables that the reference application (Vent_Analysis,
CI.py and SimpleITK's N4 defaults) and the port's own copy of them
(``ventjax_torch/ops/geometry.py`` at the commit that added this
benchmark) define: N4's dense cubic B-spline basis and histogram FFT
length, and the Cluster Index sphere-shell table with its balls.  It
imports nothing of the program, so the reference works these out again
rather than reading what the program's set-up built.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def next_pow2_padded(n: int) -> int:
    """ITK pads the sharpening histogram's FFT to exp2(ceil(log2(n)) + 1)."""
    return int(2 ** (np.ceil(np.log2(n)) + 1))


def bspline_basis_1d(n: int, n_elements: int) -> np.ndarray:
    """Dense [n, n_elements + 3] uniform cubic B-spline basis: grid
    position i sits at t = i / (n - 1) * n_elements, with four nonzero
    blending weights on control points span .. span + 3."""
    t = np.arange(n, dtype=np.float64) / max(n - 1, 1) * n_elements
    span = np.minimum(np.floor(t).astype(int), n_elements - 1)
    u = t - span
    b = np.stack([(1 - u) ** 3 / 6.0,
                  (3 * u ** 3 - 6 * u ** 2 + 4) / 6.0,
                  (-3 * u ** 3 + 3 * u ** 2 + 3 * u + 1) / 6.0,
                  u ** 3 / 6.0], axis=1)
    basis = np.zeros((n, n_elements + 3))
    for j in range(4):
        basis[np.arange(n), span + j] = b[:, j]
    return basis


@functools.lru_cache(maxsize=4)
def sphere_pixels(vox: Tuple[float, float, float], radius: int) -> np.ndarray:
    """[M, 4] rows (radius, di, dj, dk) of CI.py's getSpherePix: shells
    grown on r = arange(0, radius, 0.01) in voxel-scaled space vox /
    min(vox), membership (r - 0.01)^2 < d^2 <= r^2 (an offset on a float
    boundary can sit in two shells, and then has two rows), shells in
    radius order and, within one, in the scan order of the reference's
    ``X, Z, Y = np.meshgrid(...)``; the table starts with one [0,0,0,0]."""
    vox_arr = np.asarray(vox, dtype=np.float64)
    scale = vox_arr / np.min(vox_arr)
    rng = np.arange(-radius, radius + 1)
    Z, X, Y = np.meshgrid(rng, rng, rng, indexing="ij")
    d2 = ((X * scale[0]) ** 2 + (Y * scale[1]) ** 2
          + (Z * scale[2]) ** 2).ravel()
    x, y, z = X.ravel(), Y.ravel(), Z.ravel()
    r_grid = np.arange(0, radius, 0.01)
    lo = (r_grid - 0.01) ** 2
    hi = r_grid ** 2
    k0 = np.searchsorted(hi, d2, side="left")
    rows = []
    for dk in (-1, 0, 1):
        k = k0 + dk
        ok = (k >= 0) & (k < len(r_grid))
        kk = np.clip(k, 0, len(r_grid) - 1)
        idx = np.nonzero(ok & (d2 <= hi[kk]) & (d2 > lo[kk]))[0]
        if len(idx):
            rows.append(np.column_stack(
                [r_grid[kk[idx]], x[idx], y[idx], z[idx], idx]))
    allrows = np.concatenate(rows, axis=0)
    order = np.lexsort((allrows[:, 4], allrows[:, 0]))
    return np.vstack([np.zeros((1, 4)), allrows[order][:, :4]])


def shell_structure(px: np.ndarray):
    """(radii, sizes, starts) of the table's shells: ball j is the prefix
    of the table through shell j, of radius radii[j]."""
    r = px[:, 0]
    change = np.nonzero(np.diff(r) > 0)[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(r)]])
    return r[starts], ends - starts, starts


def alias_combos(shape: Tuple[int, int, int]):
    """The (p, q, s) index shifts with p + q*H + s*H*W = 0 and |p| <= H:
    the offsets by which CI.py's unclamped linear index (i + (j-1)H +
    (k-1)HW) wraps one voxel onto another.  A witness w counts for center
    v under shift (p, q, s) when w - v + (p, q, s) is a sphere offset."""
    H, W, _ = shape
    return [(0, 0, 0), (0, W, -1), (0, -W, 1), (H, -1, 0), (H, W - 1, -1),
            (H, -W - 1, 1), (-H, 1, 0), (-H, 1 - W, 1), (-H, 1 + W, -1)]
