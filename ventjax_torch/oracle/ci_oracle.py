"""CPU oracle for the Cluster Index (CI) map.

The port's copy of ``ventjax/oracle/ci_oracle.py``, with the same names and
arithmetic.  It replicates the reference CI module (CI.py) exactly,
including its quirks:

- Sphere geometry identical to getSpherePix (CI.py:33-63): shells grown on
  the float64 grid r = np.arange(0, Rmax, 0.01) with membership
  (r-0.01)^2 < d2 <= r^2 in voxel-scaled space vox/min(vox); the table
  starts with a single [0,0,0,0] row.  The table is built once, in
  ``ops/geometry.py``, and shared with the CI engines.
- Linear-index aliasing at volume borders (CI.py:65-68): px2vec has no
  bounds clamp, so out-of-bounds sphere voxels wrap in index space.
- intersect1d uniqueness (CI.py:96): duplicate aliased indices count once in
  the numerator, while the denominator is the raw prefix row count.
- First-crossing semantics (CI.py:94-105): CV(v) = radius of the first ball
  whose defect fraction drops below 0.5; the final shell's complete prefix
  is never tested; if no prefix fails, the reference raises ValueError
  (``saturate=True`` keeps the last tested radius instead).
"""
from __future__ import annotations

import numpy as np

from ventjax_torch.ops.geometry import shell_structure, sphere_pixels

__all__ = ["sphere_pixels", "shell_structure", "calculate_ci_oracle",
           "subject_ci"]


def calculate_ci_oracle(
    defect: np.ndarray,
    vox=(1, 1, 1),
    rmax: int = 50,
    saturate: bool = False,
) -> np.ndarray:
    """CI map: per defect voxel, CV * min(vox) mm (CI.py:107-145).

    With saturate=False, raises ValueError when a voxel never drops below the
    0.5 fraction before the last tested prefix — matching CI.py:101-104.
    """
    defect = np.asarray(defect)
    H, W, D = defect.shape
    HW = H * W
    vox_arr = np.asarray(vox, dtype=np.float64)
    px = sphere_pixels(vox_arr, rmax)
    radii, sizes, starts = shell_structure(px)

    # Linear-index deltas (the aliasing map).  vec(v+o) = vec(v) + delta(o)
    # where vec(i,j,k) = i + (j-1)H + (k-1)HW (CI.py:65-68).
    delta = (px[:, 1] + px[:, 2] * H + px[:, 3] * HW).astype(np.int64)
    # intersect1d counts unique values: mark the first occurrence of each
    # delta so aliased duplicates count once in the numerator.
    _, first_idx = np.unique(delta, return_index=True)
    is_first = np.zeros(len(delta), dtype=bool)
    is_first[first_idx] = True

    # Defect voxel set in vec space (injective over valid coords).
    dv = np.argwhere(defect != 0)
    def_vec = dv[:, 0] + (dv[:, 1] - 1) * H + (dv[:, 2] - 1) * HW

    n_shells = len(radii)
    ci = np.zeros(defect.shape, dtype=np.float64)
    min_vox = float(np.min(vox_arr))
    def_vec_sorted = np.sort(def_vec)
    rows_ball = np.cumsum(sizes)

    for (i, j, k), base in zip(dv, def_vec):
        # Unique-value membership of every sphere voxel (vectorized per voxel).
        hit = is_first & np.isin(base + delta, def_vec_sorted)
        cum_hits = np.cumsum(np.add.reduceat(hit, starts))
        frac = cum_hits / rows_ball
        # The reference tests balls 0..M-2 in order (the full-table prefix is
        # never tested) and takes the radius of the first failing ball.
        failing = frac[: n_shells - 1] < 0.5
        if failing.any():
            cv = radii[int(np.argmax(failing))]
        elif saturate:
            cv = radii[n_shells - 1]
        else:
            raise ValueError(f"MAX RADIUS reached at voxel ({i},{j},{k})")
        ci[i, j, k] = cv * min_vox
    return ci


def subject_ci(ci_map: np.ndarray, defect: np.ndarray,
               percentile: float = 0.95) -> float:
    """Subject CI = sorted CI values over defect voxels at index
    int(p * len) (Vent_Analysis.py:268-270)."""
    cvlist = np.sort(ci_map[defect > 0])
    return float(cvlist[int(percentile * len(cvlist))])
