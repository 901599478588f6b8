"""Frozen configuration of the ventjax_torch pipeline.

The port's own copy of ``VentConfig``: the same fields, defaults and
meaning as the reference package's, so one study analysed by either package
with the default configuration runs the same algorithm.  Every field is
immutable, so a config is hashable and can key a cache (``make_analyze_fn``).
Fields that steer only the reference package (``n4_use_pallas``,
``ci_shard_slices``, ``compute_dtype``) are kept so that the two configs
stay field for field alike; the port does not read them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VERSION = "0.1.0"


@dataclasses.dataclass(frozen=True)
class VentConfig:
    """All pipeline constants.  Defaults replicate the reference behaviour
    (Vent_Analysis.py and CI.py of the Vent_Analysis application)."""

    # ---- Mean-anchored VDP (Thomen 2015) ------------------------------------
    # Defect threshold on the mean-normalised N4 signal.
    vdp_thresh: float = 0.6
    # Median filter kernel applied per slice to the defect mask.
    median_kernel: int = 3

    # ---- Linear-binning VDP (Mu He 2016) ------------------------------------
    # Normaliser: sorted masked signal at index int(len * 0.99).
    lb_percentile: float = 0.99
    # Bin edges of the 6-way linear binning.
    lb_edges: Tuple[float, ...] = (0.16, 0.34, 0.52, 0.70, 0.88)
    # Bins counted as defect for VDP_lb.
    lb_defect_bins: Tuple[int, ...] = (1, 2)

    # ---- SNR ----------------------------------------------------------------
    # Rows zeroed at the top and bottom of the noise mask.
    snr_fov_buffer: int = 20

    # ---- K-means VDP (Kirby 2012) -------------------------------------------
    kmeans_clusters: int = 4
    kmeans_iters: int = 30
    # Number of lowest-mean clusters counted as defect.
    kmeans_defect_clusters: int = 1

    # ---- Cluster Index ------------------------------------------------------
    # Largest sphere radius in scaled-voxel units.
    ci_rmax: int = 50
    # Defect fraction threshold for sphere growing.
    ci_defect_frac: float = 0.5
    # Radius grid step for shell growing.
    ci_shell_step: float = 0.01
    # Subject CI = this percentile of the CI map over the defect voxels.
    ci_percentile: float = 0.95
    # Upper bound on the defect voxels per volume (the defect list's pad;
    # more is flagged in StudyMetrics.ci_overflow).
    ci_max_defect_voxels: int = 8192
    # Tail budget of the pairwise engine's two-phase resolve; None = the
    # engine default max(256, K // 8).
    ci_tail_k: Optional[int] = None
    # "wrap" replicates the reference's linear-index aliasing at volume
    # borders; "pad" is the zero-padded geometry.
    ci_border_mode: str = "wrap"
    # Saturate CV at Rmax instead of raising; counted in StudyMetrics.
    ci_saturate_rmax: bool = True
    # CI engine: "pairwise", "ladder" or "full" (all exact).
    ci_engine: str = "pairwise"
    # Slice-axis sharding of the CI map over several devices (reference
    # package only).
    ci_shard_slices: int = 0

    # ---- N4 bias-field correction (ITK defaults) ----------------------------
    n4_fitting_levels: int = 4
    n4_max_iters: int = 50
    n4_convergence_threshold: float = 0.001
    n4_histogram_bins: int = 200
    n4_bias_fwhm: float = 0.15
    n4_wiener_noise: float = 0.01
    n4_spline_order: int = 3
    # Control points per dimension at the coarsest level.
    n4_control_points: int = 4
    # Bound on the masked voxels per lane in the compacted N4 iteration;
    # more is flagged in StudyMetrics.n4_overflow.
    n4_mask_pad: int = 65536
    # B-spline fit route of the reference package (its Pallas kernels).
    n4_use_pallas: "bool | None" = None

    # ---- Report / screenshot ------------------------------------------------
    parula_scale_num: int = 64
    parula_scale_den: int = 40
    screenshot_crop_border: int = 5
    montage_rows: int = 7

    # ---- Volume geometry ----------------------------------------------------
    # Voxel dims [row, col, slice] in mm when no DICOM header gives them.
    default_vox: Tuple[float, float, float] = (1.5, 1.5, 10.0)

    # ---- Numerics -----------------------------------------------------------
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "VentConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = VentConfig()
