"""The fused study pipeline on a [N,H,W,D] batch.

Counterpart of ``ventjax/pipeline/analyze.py``: SNR -> one shared mask
compaction -> N4 -> mean-anchored VDP -> linear-binning VDP -> k-means VDP
-> pairwise CI map -> metrics.  Everything runs on the device of the input
tensors.  A subject with an empty mask gets NaN metrics and valid=False
without touching the other lanes.

On a card, N4 runs kernels K4, K5, K1 and K2 on every iteration of every
level and the CI head runs K3; the CI map is the scatter, ventjax's default
(``calculate_ci_pairwise(..., pallas_densify=True)`` takes kernels K9 and
K8 instead, with the same bits).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ventjax.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.ops.basic import (
    gradient_border, masked_sorted_index, sort_compact_masked,
)
from ventjax_torch.ops.ci_pairwise import (
    CIPairwiseGeometry, build_ci_pairwise_geometry, calculate_ci_pairwise,
)
from ventjax_torch.ops.kmeans import vdp_kmeans
from ventjax_torch.ops.n4 import n4_bias_correction
from ventjax_torch.ops.snr import calculate_snr
from ventjax_torch.ops.vdp import vdp_linear_binning, vdp_mean_anchored
from ventjax_torch.pipeline.result import StudyMetrics, VentResult


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(1)


def analyze_cohort(
    hp: torch.Tensor,
    mask: torch.Tensor,
    geom: CIPairwiseGeometry,
    config: VentConfig = DEFAULT_CONFIG,
    export_compact: bool = False,
) -> VentResult:
    """Full analysis of a [N,H,W,D] batch on ``hp.device``."""
    # Full float32 products on the card: the pipeline's tolerances assume
    # them (TF32 keeps about three decimal digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = config
    if not isinstance(geom, CIPairwiseGeometry):
        raise TypeError("analyze_cohort: geom must come from build_geometry")
    N = hp.shape[0]
    hp = hp.to(torch.float32)
    mask = mask.to(device=hp.device, dtype=torch.float32)
    n_mask = _sum(mask > 0)
    valid = n_mask > 0
    # An all-empty mask would give infs and NaNs inside the ops; run that
    # lane on a trivial mask and invalidate its metrics afterwards.
    safe_mask = torch.where(valid[:, None, None, None], mask,
                            torch.ones_like(mask))

    snr = calculate_snr(hp, safe_mask, c.snr_fov_buffer)

    # One mask compaction, shared by N4 (which sub-masks img > 0 through
    # its weights) and k-means (which consumes N4's compacted output).
    V = int(np.prod(hp.shape[1:]))
    P = V if c.n4_mask_pad is None else min(int(c.n4_mask_pad), V)
    comp = sort_compact_masked(hp.reshape(N, -1),
                               safe_mask.reshape(N, -1) > 0, P)
    n4_out = n4_bias_correction(
        hp, safe_mask,
        fitting_levels=c.n4_fitting_levels,
        max_iters=c.n4_max_iters,
        convergence_threshold=c.n4_convergence_threshold,
        bins=c.n4_histogram_bins,
        fwhm=c.n4_bias_fwhm,
        wiener_noise=c.n4_wiener_noise,
        control_points=c.n4_control_points,
        mask_pad=c.n4_mask_pad,
        return_overflow=True,
        return_phi=export_compact,
        return_compacted=True,
        compacted=comp,
    )
    if export_compact:
        n4, n4_overflow, n4_phi, n4_comp = n4_out
    else:
        n4, n4_overflow, n4_comp = n4_out

    defect, vdp = vdp_mean_anchored(n4, safe_mask, c.vdp_thresh)
    defect_border = (gradient_border(defect) == 1).to(torch.float32)
    defect_lb, vdp_lb = vdp_linear_binning(n4, safe_mask, c.lb_edges,
                                           c.lb_percentile)
    _, n4_vals_c, wv_c = n4_comp
    defect_km, vdp_km = vdp_kmeans(
        n4, safe_mask, c.kmeans_clusters, c.kmeans_iters,
        c.kmeans_defect_clusters, compacted=(n4_vals_c, wv_c))
    ci_map, n_saturated, ci_overflow = calculate_ci_pairwise(
        defect, geom, c.ci_max_defect_voxels, tail_k=c.ci_tail_k)

    # Subject CI: the floor-index percentile of the CI map over defect
    # voxels; NaN when there are none.
    has_defect = _sum(defect) > 0
    nan = torch.full_like(snr, float("nan"))
    ci_val = torch.where(
        has_defect, masked_sorted_index(ci_map, defect, c.ci_percentile), nan)

    vox_cc = float(np.prod(geom.vox) / 1000.0)   # mm^3 -> cc
    lung_volume = _sum(mask == 1) * vox_cc / 1000.0        # liters
    defect_volume = _sum(defect == 1) * vox_cc / 1000.0

    nanify = lambda x: torch.where(valid, x.to(torch.float32), nan)
    metrics = StudyMetrics(
        snr=nanify(snr),
        vdp=nanify(vdp),
        vdp_lb=nanify(vdp_lb),
        vdp_km=nanify(vdp_km),
        lung_volume=lung_volume,
        defect_volume=nanify(defect_volume),
        ci=nanify(ci_val),
        ci_saturated=n_saturated,
        ci_overflow=ci_overflow,
        n4_overflow=n4_overflow,
        valid=valid,
    )
    export = None
    if export_compact:
        export = {"n4_cv": n4.reshape(N, -1).gather(1, comp[0]),
                  "phi": n4_phi}
    return VentResult(n4=n4, defect=defect, defect_lb=defect_lb,
                      defect_km=defect_km, defect_border=defect_border,
                      ci_map=ci_map, metrics=metrics, export=export)


def analyze_study(
    hp: torch.Tensor,
    mask: torch.Tensor,
    geom: CIPairwiseGeometry,
    config: VentConfig = DEFAULT_CONFIG,
    export_compact: bool = False,
) -> VentResult:
    """Full analysis of one [H,W,D] study: analyze_cohort on a batch of 1."""
    res = analyze_cohort(hp[None], mask[None], geom, config, export_compact)
    strip = lambda x: x[0] if isinstance(x, torch.Tensor) else x
    metrics = StudyMetrics(**{f.name: strip(getattr(res.metrics, f.name))
                              for f in dataclasses.fields(StudyMetrics)})
    export = None if res.export is None else {
        k: strip(v) for k, v in res.export.items()}
    return VentResult(
        n4=res.n4[0], defect=res.defect[0], defect_lb=res.defect_lb[0],
        defect_km=res.defect_km[0], defect_border=res.defect_border[0],
        ci_map=res.ci_map[0], metrics=metrics, export=export)


def build_geometry(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    config: VentConfig = DEFAULT_CONFIG,
) -> CIPairwiseGeometry:
    """CI geometry of the pairwise engine (cached per vox/shape).

    The port has only the pairwise engine so far.  Where the config asks
    for another engine, or the geometry fails the pairwise engine's
    float32 exactness proof, this raises NotImplementedError: the
    gather-ladder engine (ventjax/ops/ci.py) that ventjax falls back to is
    a later slice of the port.
    """
    if config.ci_engine != "pairwise":
        raise NotImplementedError(
            f"ci_engine={config.ci_engine!r}: only the pairwise CI engine is "
            "ported; the ladder/full engines (ventjax/ops/ci.py) are not yet")
    try:
        return build_ci_pairwise_geometry(
            tuple(vox), tuple(shape), config.ci_rmax, config.ci_border_mode)
    except ValueError as err:
        raise NotImplementedError(
            f"vox={tuple(vox)} fails the pairwise CI engine's exactness "
            f"proof ({err}); ventjax falls back to the gather-ladder engine "
            "(ventjax/ops/ci.py), which is not yet ported") from err
