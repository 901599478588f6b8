"""Montage helpers (skimage-free, NumPy only).

The port's copy of ``ventjax/report/montage.py``.  Replicates the two
montage styles the reference uses:
- skimage.util.montage(frames, grid_shape=(rows, cols), padding_width=0,
  fill=0) over the slice axis (Vent_Analysis.py:491-493, 644-645);
- the free-form makeMontage of the playground script with per-slice
  normalization.
"""
from __future__ import annotations

import numpy as np

from ventjax_torch.oracle.reference import normalize


def montage(volume: np.ndarray, grid_shape=None, fill: float = 0.0) -> np.ndarray:
    """[H, W, D] -> 2-D montage with slices laid out row-major on the grid."""
    H, W, D = volume.shape
    if grid_shape is None:
        rows = int(np.ceil(np.sqrt(D)))
        cols = int(np.ceil(D / rows))
    else:
        rows, cols = grid_shape
        if rows * cols < D:
            # skimage.util.montage raises here too — silently dropping
            # slices would produce report images with missing data
            raise ValueError(
                f"grid_shape {grid_shape} cannot hold {D} slices")
    out = np.full((rows * H, cols * W), fill, dtype=volume.dtype)
    for k in range(min(D, rows * cols)):
        r, c = divmod(k, cols)
        out[r * H:(r + 1) * H, c * W:(c + 1) * W] = volume[:, :, k]
    return out


def montage_row(volume: np.ndarray) -> np.ndarray:
    """abs() slices in a single row (array3D_to_montage2D,
    Vent_Analysis.py:644-645)."""
    return montage(np.abs(volume), grid_shape=(1, volume.shape[2]))


def make_montage(a: np.ndarray, n_rows=None, n_cols=None,
                 same_scale: bool = False) -> np.ndarray:
    """Playground-style montage with optional per-slice normalization and a
    final global min-max normalize (the playground's makeMontage)."""
    D = a.shape[2]
    if n_rows is not None:
        n_cols = int(np.ceil(D / n_rows))
    elif n_cols is not None:
        n_rows = int(np.ceil(D / n_cols))
    else:
        n_rows = n_cols = int(np.ceil(np.sqrt(D)))

    tiles = np.zeros((n_rows * a.shape[0], n_cols * a.shape[1]))
    for k in range(min(D, n_rows * n_cols)):
        r, c = divmod(k, n_cols)
        tile = a[:, :, k] if same_scale else normalize(a[:, :, k])
        tiles[r * a.shape[0]:(r + 1) * a.shape[0],
              c * a.shape[1]:(c + 1) * a.shape[1]] = tile
    return normalize(tiles)


def color_binary(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Gray image with binary overlay painted red, scaled to 0-255
    (GUI colorBinary helper, Vent_Analysis.py:628-634)."""
    a = normalize(a)
    out = np.zeros((a.shape[0], a.shape[1], 3))
    out[:, :, 0] = a * (b == 0) + b
    out[:, :, 1] = a * (b == 0)
    out[:, :, 2] = a * (b == 0)
    return out * 255
