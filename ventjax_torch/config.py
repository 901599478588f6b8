"""Frozen configuration of the ventjax_torch pipeline.

The port's own copy of ``VentConfig``: the same fields, defaults and
meaning as the reference package's, so one study analysed by either package
with the default configuration runs the same algorithm.  Every field is
immutable, so a config is hashable and can key a cache (``make_analyze_fn``).
Fields that steer only the reference package (``n4_use_pallas``,
``compute_dtype``) are kept so that the two configs stay field for field
alike; the port does not read them.

``StudyPreset`` and ``STUDY_PRESETS`` are the per-study schemas of the
reference GUI (GenXe, Mepo, Clinical), read by ``analyze --irb``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VERSION = "0.1.0"
# Version string of the reference pipeline this build tracks for parity
# (the reference class sets self.version = '241007_vent').
REFERENCE_VERSION = "241007_vent"


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
    # Slice-axis sharding of the compat CI map over this many devices
    # (dist/halo.py); 0 or 1 = one device.
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


@dataclasses.dataclass(frozen=True)
class StudyPreset:
    """One IRB study type: the reference GUI's GenXe / Mepo / Clinical
    columns as data.

    Carries the per-study metadata schema (which ID key the study uses,
    which treatment arms are valid, which extra metadata fields the GUI
    collected) plus the scientific VentConfig.  The CLI uses this to
    validate --treatment/--visit against the study's arms and to stamp
    study provenance into exported metadata; the filename grammar
    (``ventjax_torch.report.export.study_filename``) consumes the same
    ``irb`` key.
    """

    irb: str                      # grammar key ('genxe'|'mepo'|'clinical')
    id_field: str                 # metadata key for the subject ID
    id_label: str                 # GUI label (provenance)
    treatments: Tuple[str, ...]   # valid treatment/timepoint arms
    visits: Tuple[str, ...]       # valid visit choices ('' = free-form #)
    extra_fields: Tuple[str, ...]  # additional per-study metadata keys
    config: VentConfig = DEFAULT_CONFIG

    def validate(self, treatment: str = None, visit: str = None) -> None:
        if treatment and self.treatments and treatment not in self.treatments:
            raise ValueError(
                f"{self.irb}: treatment {treatment!r} not in "
                f"{self.treatments}"
            )
        if visit and self.visits and visit not in self.visits:
            raise ValueError(
                f"{self.irb}: visit {visit!r} not in {self.visits}"
            )


# Study schemas of the reference GUI's columns and its export filename
# grammar.
STUDY_PRESETS = {
    "genxe": StudyPreset(
        irb="genxe",
        id_field="genxe_id",
        id_label="General Xenon ID",
        # the metadata['treatment'] values the GUI sets
        treatments=("preAlbuterol", "postAlbuterol",
                    "preSildenafil", "postSildenafil"),
        visits=(),
        extra_fields=("Disease",),  # Healthy/Asthma/CF/COPD/Other radio
    ),
    "mepo": StudyPreset(
        irb="mepo",
        id_field="mepo_id",
        id_label="Mepo ID",
        treatments=("preAlb", "postAlb"),
        visits=("1", "2", "3"),     # Baseline / 4-week / 12-week radios
        extra_fields=("mepo_subject_number",),
    ),
    "clinical": StudyPreset(
        irb="clinical",
        id_field="clinical_id",
        id_label="Clinical Subject Initials",
        # metadata['treatment'] is 'none' or 'Albuterol' in the reference;
        # the filename grammar keys off 'Albuterol' vs anything else
        # ('baseline').
        treatments=("baseline", "Albuterol"),
        visits=(),                  # free-form visit number
        extra_fields=(),
    ),
}


def preset(name: str) -> StudyPreset:
    try:
        return STUDY_PRESETS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown study preset {name!r}; available: {sorted(STUDY_PRESETS)}"
        ) from None
