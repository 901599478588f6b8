"""NumPy oracle for the non-CI analysis ops.

The port's copy of ``ventjax/oracle/reference.py``, with the same names and
arithmetic.  Each function mirrors the corresponding formula of the
reference application (Vent_Analysis.py) voxel-for-voxel; quirks of the
reference are reproduced on purpose and flagged with `QUIRK:` comments.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
# NOTE: scipy is imported lazily inside vdp_mean_anchored — the report
# layer reuses this module's normalize/crop helpers, and scipy must stay
# an oracle-only optional dependency (pyproject [oracle] extra).


def normalize(x: np.ndarray) -> np.ndarray:
    """Min-max normalize with zero-range guard (Vent_Analysis.py:233-237)."""
    rng = np.max(x) - np.min(x)
    if rng == 0:
        return x
    return (x - np.min(x)) / rng


def calculate_border(a: np.ndarray) -> np.ndarray:
    """Per-slice gradient border of a binary volume (Vent_Analysis.py:225-231).

    border = (d/drow != 0) OR (d/dcol != 0), slice by slice, as 0/1 floats.
    """
    border = np.zeros(a.shape)
    for k in range(a.shape[2]):
        gr, gc = np.gradient(a[:, :, k].astype(float))
        border[:, :, k] = (gr != 0) + (gc != 0)
    return border


def crop_to_data(a: np.ndarray, border: int = 0, border_slices: bool = False):
    """Crop rows/cols/slices to the nonzero extent (Vent_Analysis.py:430-456).

    Returns (cropped, rows_idx, cols_idx, slices_idx) like the reference.

    QUIRK preserved: the reference
    builds each index list as ``np.multiply(has_signal, range(n))`` and then
    filters on truthiness (Vent_Analysis.py:433-440), so index 0 is ``0 * True
    == 0`` -> falsy and can NEVER appear — data touching row/col/slice 0 is
    cropped away, and a mask living ONLY at index 0 on some axis raises
    IndexError exactly like the reference does.
    """
    slices = [k for k in range(1, a.shape[2]) if a[:, :, k].sum() > 0]
    rows = [r for r in range(1, a.shape[0]) if a[r, :, :].sum() > 0]
    cols = [c for c in range(1, a.shape[1]) if a[:, c, :].sum() > 0]
    if border_slices:
        s0, s1 = max(slices[0] - border, 0), min(slices[-1] + border + 1, a.shape[2])
    else:
        s0, s1 = max(slices[0], 0), min(slices[-1] + 1, a.shape[2])
    r0, r1 = max(rows[0] - border, 0), min(rows[-1] + border + 1, a.shape[0])
    c0, c1 = max(cols[0] - border, 0), min(cols[-1] + border + 1, a.shape[1])
    return (
        a[r0:r1, c0:c1, s0:s1],
        list(range(r0, r1)),
        list(range(c0, c1)),
        list(range(s0, s1)),
    )


def calculate_snr(a: np.ndarray, mask: np.ndarray, fov_buffer: int = 20) -> float:
    """SNR with the reference's quirky noise-mask construction
    (Vent_Analysis.py:337-357).

    signal = all voxels under the mask; noise = voxels still 1 in a noisemask
    built by zeroing np.ix_(rr, cc, ss) where:
      - rr = (row-has-mask) * row_index  -> QUIRK: index 0 is in the set
        whenever any maskless row exists (its product is 0), so row 0 is
        always zeroed alongside the mask rows;
      - cc = contiguous arange(min_nonzero_col, max_col)  -> QUIRK: excludes
        the max col itself and can never start at col 0;
      - ss = like rr for slices (slice 0 always zeroed).
    Then the first and last `fov_buffer` rows are zeroed.
    """
    signal = a[mask > 0]
    noisemask = np.ones(mask.shape)
    rr = (np.sum(np.sum(mask, axis=2), axis=1) > 0) * np.arange(mask.shape[0])
    cc = (np.sum(np.sum(mask, axis=0), axis=1) > 0) * np.arange(mask.shape[1])
    cc = np.arange(np.min(cc[cc > 0]), np.max(cc))
    ss = (np.sum(np.sum(mask, axis=1), axis=0) > 0) * np.arange(mask.shape[2])
    noisemask[np.ix_(rr, cc, ss)] = 0
    noisemask[:fov_buffer, :, :] = 0
    noisemask[(noisemask.shape[0] - fov_buffer):, :, :] = 0
    noise = a[noisemask == 1]
    return float((np.mean(signal) - np.mean(noise)) / np.std(noise))


def vdp_mean_anchored(
    n4: np.ndarray, mask: np.ndarray, thresh: float = 0.6
) -> Tuple[np.ndarray, float]:
    """Mean-anchored VDP [Thomen 2015] (Vent_Analysis.py:244-252).

    Returns (defectArray, VDP).  defect = per-slice medfilt2d of
    (n4/mean(masked) < thresh) * mask with the default 3x3 kernel.
    """
    from scipy.signal import medfilt2d

    signal = n4[mask > 0]
    mean_norm = n4 / np.mean(signal)
    defect = np.zeros(mean_norm.shape)
    for k in range(mask.shape[2]):
        defect[:, :, k] = medfilt2d((mean_norm[:, :, k] < thresh) * mask[:, :, k])
    vdp = 100 * np.sum(defect) / np.sum(mask)
    return defect, float(vdp)


def vdp_linear_binning(
    n4: np.ndarray, mask: np.ndarray,
    edges=(0.16, 0.34, 0.52, 0.70, 0.88),
    percentile: float = 0.99,
) -> Tuple[np.ndarray, float]:
    """Linear-binning VDP [Mu He 2016] (Vent_Analysis.py:254-257).

    Normalizer = sorted masked signal at index int(len * .99) (floor index —
    QUIRK: the reference names the variable `norm95th_vent` but uses .99).
    Returns (defectArrayLB with bins 1..6 under the mask, VDP_lb).
    """
    signal_list = sorted(n4[mask > 0])
    norm = n4 / signal_list[int(len(signal_list) * percentile)]
    e = edges
    lb = (
        (norm <= e[0]) * 1
        + (norm > e[0]) * (norm <= e[1]) * 2
        + (norm > e[1]) * (norm <= e[2]) * 3
        + (norm > e[2]) * (norm <= e[3]) * 4
        + (norm > e[3]) * (norm <= e[4]) * 5
        + (norm > e[4]) * 6
    ) * mask
    vdp_lb = 100 * np.sum((lb == 1) * 1 + (lb == 2) * 1) / np.sum(mask)
    return lb, float(vdp_lb)


def vdp_kmeans(
    n4: np.ndarray, mask: np.ndarray, k: int = 4, iters: int = 30,
    defect_clusters: int = 1, init_centers=None,
) -> Tuple[np.ndarray, float]:
    """K-means VDP [Kirby 2012] — a stub in the reference
    (Vent_Analysis.py:259-261, metadata key 'VDP_km' at line 90), implemented
    for real here: Lloyd's algorithm on the masked intensities with
    deterministic quantile initialization; the lowest-mean cluster(s) are
    defect.  This NumPy version is the oracle for ops.kmeans.
    """
    vals = np.asarray(n4[mask > 0], dtype=np.float64)
    if init_centers is not None:
        # Override for loop-equivalence tests: the device op quantizes its
        # quantile init through a 32-bit bitspace selection, so comparing
        # loops requires starting both from the same centers.
        centers = np.asarray(init_centers, dtype=np.float64).copy()
    else:
        # Deterministic init: evenly spaced quantiles of the masked values.
        qs = (np.arange(k) + 0.5) / k
        centers = np.quantile(vals, qs)
    for _ in range(iters):
        assign = np.argmin(np.abs(vals[:, None] - centers[None, :]), axis=1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                centers[j] = vals[sel].mean()
    # Labels come from the FINAL centers (one last E-step) — standard
    # Lloyd's output semantics, and what the device op computes; without
    # this, an unconverged run (iters exhausted first) would label with
    # stale pre-update centers.
    assign = np.argmin(np.abs(vals[:, None] - centers[None, :]), axis=1)
    order = np.argsort(centers)
    rank = np.empty(k, dtype=int)
    rank[order] = np.arange(k)
    assign_rank = rank[assign]
    defect_sel = assign_rank < defect_clusters
    defect = np.zeros(n4.shape)
    defect[mask > 0] = defect_sel.astype(float)
    vdp_km = 100 * np.sum(defect) / np.sum(mask)
    return defect, float(vdp_km)


def build_4d_array(
    hp: np.ndarray,
    mask: np.ndarray,
    proton=None,
    n4=None,
    defect=None,
    ci=None,
) -> np.ndarray:
    """6-channel export array in the reference's fixed channel order
    [proton, HPvent, mask, N4HPvent, defectArray, CIarray]
    (Vent_Analysis.py:292-313); missing channels stay zero.

    Like the reference, each optional channel is a guarded ASSIGNMENT
    (try/except, Vent_Analysis.py:296-312): an array that numpy can
    broadcast into [H,W,D] fills the channel even when its shape differs
    (e.g. a (H,W,1) proton), and only a failing assignment leaves zeros."""
    # Fortran allocation (values/semantics identical to the reference's
    # default-C np.zeros — only the memory layout differs): NIfTI
    # serializes in F order, and in F layout each [H,W,D] channel slab is
    # contiguous, so both the per-channel fills and nifti.save's
    # tobytes(order="F") become straight copies.
    out = np.zeros((hp.shape[0], hp.shape[1], hp.shape[2], 6),
                   dtype=np.float32, order="F")
    out[:, :, :, 1] = hp
    out[:, :, :, 2] = mask
    for idx, arr in ((0, proton), (3, n4), (4, defect), (5, ci)):
        if arr is None:
            continue
        try:
            out[:, :, :, idx] = arr
        except Exception:  # noqa: BLE001 — mirrors the reference's bare
            # except (Vent_Analysis.py:296-313): ANY failing assignment
            # (shape mismatch, object dtype, exotic array-likes raising
            # arbitrary errors) leaves the channel zeroed, silently.
            pass
    return out


def lung_volume_liters(mask: np.ndarray, vox) -> float:
    """LungVolume in liters (Vent_Analysis.py:166,223):
    sum(mask==1) * prod(vox/10) / 1000."""
    return float(np.sum(mask == 1) * np.prod(np.divide(vox, 10)) / 1000)
