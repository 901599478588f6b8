"""Host-side (NumPy, float64) geometry tables the port builds once per shape.

- ``bspline_basis_1d`` and ``_next_pow2_padded``: N4's dense cubic B-spline
  basis over a regular grid, and ITK's histogram FFT length (``ops/n4.py``).
- ``sphere_pixels`` and ``shell_structure``: the Cluster Index sphere-shell
  table and its decomposition into balls (``ops/ci_pairwise.py`` and
  ``ops/ci.py``).

They are the reference package's oracle helpers, copied with the same
arithmetic so that the port builds the same tables bit for bit without
importing that package (``tests/test_torch_standalone.py`` holds them
equal).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def _next_pow2_padded(n: int) -> int:
    """ITK pads the histogram FFT to exp2(ceil(log2(n)) + 1)."""
    return int(2 ** (np.ceil(np.log2(n)) + 1))


def bspline_basis_1d(n: int, n_elements: int) -> np.ndarray:
    """Dense [n, n_elements + 3] cubic B-spline basis over a regular grid.

    Grid positions map linearly onto [0, n_elements] parametric space; each
    position gets 4 nonzero cubic blending weights on control points
    span..span+3 (uniform cubic B-spline, as in ITK's scattered-data fitter).
    """
    ncp = n_elements + 3
    t = np.arange(n, dtype=np.float64) / max(n - 1, 1) * n_elements
    span = np.minimum(np.floor(t).astype(int), n_elements - 1)
    u = t - span
    b = np.zeros((n, 4))
    b[:, 0] = (1 - u) ** 3 / 6.0
    b[:, 1] = (3 * u ** 3 - 6 * u ** 2 + 4) / 6.0
    b[:, 2] = (-3 * u ** 3 + 3 * u ** 2 + 3 * u + 1) / 6.0
    b[:, 3] = u ** 3 / 6.0
    basis = np.zeros((n, ncp))
    for j in range(4):
        basis[np.arange(n), span + j] = b[:, j]
    return basis


@functools.lru_cache(maxsize=8)
def _sphere_pixels_cached(vox: Tuple[float, float, float],
                          radius: int) -> np.ndarray:
    vox_arr = np.asarray(vox, dtype=np.float64)
    radius = int(radius)
    scale = vox_arr / np.min(vox_arr)
    rng = np.arange(-radius, radius + 1)
    # The reference builds the offsets with `X, Z, Y = np.meshgrid(...)` in
    # the default 'xy' indexing, whose C-order flat scan runs over (Z, X, Y).
    Z, X, Y = np.meshgrid(rng, rng, rng, indexing="ij")
    d2 = (X * scale[0]) ** 2 + (Y * scale[1]) ** 2 + (Z * scale[2]) ** 2
    x = X.ravel()
    y = Y.ravel()
    z = Z.ravel()
    d2 = d2.ravel()

    # Shell radii grid, float64, as the reference computes it.
    r_grid = np.arange(0, radius, 0.01)
    lo = (r_grid - 0.01) ** 2  # r_grid[k] - 0.01 != r_grid[k-1] exactly
    hi = r_grid ** 2

    # Every grid radius whose shell lo[k] < d2 <= hi[k] captures an offset;
    # float noise in `lo` can catch an offset in two adjacent shells (the
    # reference then duplicates the row), so a small window is checked.
    k0 = np.searchsorted(hi, d2, side="left")
    rows = []
    for dk in (-1, 0, 1):
        k = k0 + dk
        ok = (k >= 0) & (k < len(r_grid))
        kk = np.clip(k, 0, len(r_grid) - 1)
        member = ok & (d2 <= hi[kk]) & (d2 > lo[kk])
        idx = np.nonzero(member)[0]
        if len(idx):
            rows.append(
                np.column_stack([r_grid[kk[idx]], x[idx], y[idx], z[idx], idx])
            )
    allrows = np.concatenate(rows, axis=0)
    # Shells in radius order; within a shell, the meshgrid scan order.
    order = np.lexsort((allrows[:, 4], allrows[:, 0]))
    pxls = allrows[order][:, :4]
    # The reference's table starts with a single [0, 0, 0, 0] row.
    return np.vstack([np.zeros((1, 4)), pxls])


def sphere_pixels(vox, radius: int = 50) -> np.ndarray:
    """Nx4 [radius, di, dj, dk] sphere-shell table of the reference's
    getSpherePix (CI.py)."""
    return _sphere_pixels_cached(tuple(float(v) for v in np.asarray(vox)),
                                 int(radius))


def shell_structure(sphere_px: np.ndarray):
    """Decompose the Nx4 table into (radii, shell_sizes, shell_start_rows).

    radii[j] is the radius of ball_j = complete prefix through shell j
    (shell 0 is the lone [0,0,0,0] row).
    """
    r = sphere_px[:, 0]
    change = np.nonzero(np.diff(r) > 0)[0] + 1  # first row of each new radius
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(r)]])
    radii = r[starts]
    sizes = ends - starts
    return radii, sizes, starts
