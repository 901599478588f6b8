"""The fused study pipeline over H-slabs: one batch row of a ("batch",
"space") mesh.

The slab program of ``pipeline/analyze.py``'s ``analyze_cohort``, with
each collective that XLA derives for ventjax's ``spatial_shard_fn``
written out (``dist/space.py``):

- SNR: each slab's rows that meet the mask; the columns and slices that
  do, or-reduced across slabs; the FOV-buffer rows by global row index;
  the means and the std through ``row_sums_sharded`` (the unsharded bits).
- One mask compaction per slab with global flat indices: slab s's run of
  the lane's compacted list, whose global rank is its position plus the
  counts of the slabs before it.
- N4 over the slabs (``ops/n4_space.py``: K4, K5, K1, K2 on every slab,
  their partials combined in chunk order; the dense field on each slab's
  own rows).
- The mean-anchored VDP: the mean through ``row_sums_sharded``; the 3x3
  median and the border's gradient along H on 1-row halos.
- The linear-binning VDP and the subject CI: the volume-wide order
  statistic over each slab's sorted masked values, gathered.
- k-means: the compacted N4 output gathered (one list, [N, P] floats),
  the Lloyd centers computed once, each slab assigning its own voxels.
- The CI map: each slab's defect voxels compacted with global flat
  indices and gathered, in slab order, to the row's first shard; the
  unsharded engine (K3 in its head) runs there on that list, and each
  slab scatters its own voxels' values.  The gather-ladder engine (a
  geometry where the pairwise engine cannot prove itself exact) reads the
  whole defect volume: it is gathered to the first shard and the map's
  rows are sent back.
- Volumes and counts as exact integer sums.

Over ranks (``dist.space.on_ranks``: one slab a rank of a batch row's
group) every collective above all_gathers the row's parts and runs the
same arithmetic, so each rank's values are the one-process form's bits;
values computed once (the k-means centers, the CI engine's per-defect
values, the ladder's map) are computed on the row's first rank and
broadcast (``space.once``).

On a card every value equals the unsharded run's bit for bit.  On the CPU
N4's plain versions sum chunk by chunk (the unsharded plain versions sum
the whole list at once), so the slabs' N4 agrees within float32 rounding
and everything downstream follows it.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ventjax_torch.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.dist import space
from ventjax_torch.ops.basic import (
    compact_mask_indices, gradient_border, sort_compact_masked,
)
from ventjax_torch.ops.ci import CIGeometry, calculate_ci_staged
from ventjax_torch.ops.ci_pairwise import (
    CIPairwiseGeometry, ci_pairwise_values, coords_of,
)
from ventjax_torch.ops.kmeans import kmeans_centers, kmeans_defect
from ventjax_torch.ops.median import median3x3_binary
from ventjax_torch.ops.n4_space import n4_slabs
from ventjax_torch.ops.snr import noise_keep
from ventjax_torch.ops.vdp import linear_bins
from ventjax_torch.pipeline.result import StudyMetrics, VentResult
from ventjax_torch.utils.profiling import stage


def pipeline_of(cohort_fn):
    """(geom, config) of a cohort function that names the pipeline:
    ``functools.partial(analyze_cohort, geom=..., config=...)`` or
    ``make_analyze_fn(..., batched=True)``'s function."""
    from ventjax_torch.pipeline.analyze import AnalyzeFn, analyze_cohort

    if isinstance(cohort_fn, AnalyzeFn) and cohort_fn.batched:
        return cohort_fn.geom, cohort_fn.config
    if (isinstance(cohort_fn, functools.partial)
            and cohort_fn.func is analyze_cohort and not cohort_fn.args
            and "geom" in cohort_fn.keywords
            and set(cohort_fn.keywords) <= {"geom", "config"}):
        return (cohort_fn.keywords["geom"],
                cohort_fn.keywords.get("config", DEFAULT_CONFIG))
    raise TypeError(
        "spatial_shard_fn: the port shards the analysis pipeline only: pass "
        "functools.partial(analyze_cohort, geom=..., config=...) or "
        "make_analyze_fn(vox, shape, config, batched=True); ventjax's "
        f"sharding of any jitted function has no counterpart (got "
        f"{cohort_fn!r})")


def _count(xs) -> torch.Tensor:
    """Float32 count of the set entries of 0/1 slabs (exact below 2^24)."""
    return space.sum_in_order([x.reshape(x.shape[0], -1).sum(1) for x in xs])


def _nsum(xs) -> torch.Tensor:
    """Exact int64 count of the True entries of boolean slabs."""
    return space.sum_int([x.reshape(x.shape[0], -1).sum(1) for x in xs])


def noise_mask_slabs(masks, H: int, fov_buffer: int):
    """``ops.snr.noise_mask`` of the volume the slabs make up, per slab:
    the columns and slices that meet the mask, and whether every row
    does, or-reduced across slabs."""
    h = masks[0].shape[1]
    ms = [m > 0 for m in masks]
    row_has = [m.any(dim=3).any(dim=2) for m in ms]            # [N, h]
    col_has = space.reduce_any([m.any(dim=3).any(dim=1) for m in ms])
    slc_has = space.reduce_any([m.any(dim=2).any(dim=1) for m in ms])
    all_rows = ~space.reduce_any([~r.all(1) for r in row_has])  # [N]
    return [noise_keep(rh, space.to(col_has, rh.device),
                       space.to(slc_has, rh.device),
                       space.to(all_rows, rh.device), s * h, H, fov_buffer)
            for s, rh in space.numbered(row_has)]


def snr_slabs(a, masks, H: int, fov_buffer: int) -> torch.Tensor:
    """``ops.snr.calculate_snr`` over slabs, bit for bit."""
    nm = noise_mask_slabs(masks, H, fov_buffer)
    sig = [(m > 0).to(x.dtype) for x, m in zip(a, masks)]
    return ((space.masked_mean_sharded(a, sig)
             - space.masked_mean_sharded(a, nm))
            / space.masked_std_sharded(a, nm))


def median_slabs(xs):
    """``median3x3_binary`` of the volume, per slab, on 1-row halos."""
    return [median3x3_binary(p)[:, 1:-1]
            for p in space.with_halo(xs, 1)]


def border_slabs(xs):
    """``gradient_border`` per slab on 1-row halos: torch.gradient along H
    is one-sided only at the volume's global edges."""
    out = []
    for (s, p), x in zip(space.numbered(space.with_halo(xs, 1, edge="none")),
                         xs):
        lo = 1 if s > 0 else 0
        out.append(gradient_border(p)[:, lo:lo + x.shape[1]])
    return out


def _global_compact(xs, K: int, V: int):
    """Each slab's set entries (x != 0) as global flat indices [N, min(K,
    V_s)] and counts [N]; slab s's indices start at s * V_s."""
    runs, counts = [], []
    for s, x in space.numbered(xs):
        N = x.shape[0]
        flat = (x != 0).reshape(N, -1)
        Vs = flat.shape[1]
        idx, n = compact_mask_indices(flat, min(K, Vs))
        runs.append(idx + s * Vs)
        counts.append(n)
    return runs, counts


def ci_slabs(defects, geom, config: VentConfig, shape):
    """(CI map slabs, saturated [N], overflow [N]) of the defect slabs."""
    H, W, D = shape
    V = H * W * D
    K = config.ci_max_defect_voxels
    h = defects[0].shape[1]
    Vs = h * W * D
    dev0 = defects[0].device
    if isinstance(geom, CIGeometry):
        full = space.gather_rows(defects)
        ci_map, n_sat, ovf, stage_ovf = space.once(calculate_ci_staged, full,
                                                   geom, K)
        split = [ci_map[:, s * h:(s + 1) * h].to(x.device)
                 for s, x in space.numbered(defects)]
        return split, n_sat, ovf | (stage_ovf > 0)
    runs, counts = _global_compact(defects, K, V)
    n_def = space.sum_int(counts)
    cidx = space.gather_runs(runs, counts, K, fill=V - 1, device=dev0)
    coords, cidx, n_def, valid = coords_of(cidx, n_def, (H, W, D))
    cv, n_sat, overflow = space.once(lambda: ci_pairwise_values(
        coords, n_def, valid, geom, K, tail_k=config.ci_tail_k))
    maps = []
    for s, x in space.numbered(defects):
        dev = x.device
        N = x.shape[0]
        ci, ok = space.to(cidx, dev) - s * Vs, space.to(valid, dev)
        mine = ok & (ci >= 0) & (ci < Vs)
        flat = torch.zeros((N, Vs + 1), dtype=torch.float32, device=dev)
        flat.scatter_(1, torch.where(mine, ci, torch.full_like(ci, Vs)),
                      space.to(cv, dev))
        maps.append(flat[:, :Vs].reshape(x.shape))
    return maps, n_sat, overflow


def linear_binning_slabs(n4, masks, edges, percentile):
    """``vdp_linear_binning`` over slabs: (bin map slabs, VDP_lb [N])."""
    ms = [(m > 0).to(x.dtype) for x, m in zip(n4, masks)]
    denom = space.masked_sorted_index_sharded(n4, ms, percentile)
    lbs = [linear_bins(x, m, space.to(denom, x.device), edges)
           for x, m in zip(n4, masks)]
    vdp_lb = 100.0 * (_count([lb == 1 for lb in lbs])
                      + _count([lb == 2 for lb in lbs])) / _count(masks)
    return lbs, vdp_lb


def analyze_spatial(
    hp: torch.Tensor,
    mask: torch.Tensor,
    geom,
    config: VentConfig,
    devices: Sequence[torch.device],
    own_slab: bool = False,
) -> VentResult:
    """``analyze_cohort`` of a [N, H, W, D] batch over len(devices) H-slabs
    (slab s on devices[s]); the result's leaves on devices[0].  Under
    ``dist.space.on_ranks`` ``devices`` is this rank's one device, and
    ``own_slab`` returns this rank's slab of each volume instead of the
    row's gathered volumes (the metrics are the row's either way)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = config
    if not isinstance(geom, (CIPairwiseGeometry, CIGeometry)):
        raise TypeError("analyze_spatial: geom must come from build_geometry")
    N, H, W, D = hp.shape
    if tuple(geom.shape) != (H, W, D):
        raise ValueError(f"analyze_spatial: geometry for {geom.shape}, "
                         f"volumes of {(H, W, D)}")
    V = H * W * D
    hps = space.split_rows(hp.to(torch.float32), devices)
    h = hps[0].shape[1]
    ms = [m.to(torch.float32) for m in space.split_rows(mask, devices)]
    n_mask = _nsum([m > 0 for m in ms])
    valid = n_mask > 0
    safe = [torch.where(space.to(valid, m.device)[:, None, None, None], m,
                        torch.ones_like(m)) for m in ms]

    with stage("snr"):
        snr = snr_slabs(hps, safe, H, c.snr_fov_buffer)

    with stage("n4"):
        P = V if c.n4_mask_pad is None else min(int(c.n4_mask_pad), V)
        runs = []
        for s, (x, m) in space.numbered(list(zip(hps, safe))):
            Vs = h * W * D
            idx, vals, n = sort_compact_masked(
                x.reshape(N, -1), m.reshape(N, -1) > 0, min(P, Vs))
            runs.append((idx + s * Vs, vals, n))
        n4, n4_overflow, _, n4_comp = n4_slabs(
            hps, runs, (H, W, D), P,
            fitting_levels=c.n4_fitting_levels,
            max_iters=c.n4_max_iters,
            convergence_threshold=c.n4_convergence_threshold,
            bins=c.n4_histogram_bins,
            fwhm=c.n4_bias_fwhm,
            wiener_noise=c.n4_wiener_noise,
            control_points=c.n4_control_points)

    with stage("vdp_mean_anchored"):
        sig = [(m > 0).to(x.dtype) for x, m in zip(n4, safe)]
        mean_sig = space.masked_mean_sharded(n4, sig)
        raw = [(x / space.to(mean_sig, x.device)[:, None, None, None]
                < c.vdp_thresh).to(x.dtype) * m for x, m in zip(n4, sig)]
        defect = median_slabs(raw)
        vdp = 100.0 * _count(defect) / _count(safe)
        border = [(b == 1).to(torch.float32) for b in border_slabs(defect)]
    with stage("vdp_linear_binning"):
        defect_lb, vdp_lb = linear_binning_slabs(n4, safe, c.lb_edges,
                                                 c.lb_percentile)
    with stage("vdp_kmeans"):
        _, vals_c, wv_c = n4_comp
        centers = space.once(kmeans_centers, vals_c, wv_c,
                             c.kmeans_clusters, c.kmeans_iters)
        defect_km = [kmeans_defect(x, m, space.to(centers, x.device),
                                   c.kmeans_defect_clusters)
                     for x, m in zip(n4, safe)]
        vdp_km = 100.0 * _count(defect_km) / _count(safe)
    with stage("ci"):
        ci_map, n_saturated, ci_overflow = ci_slabs(defect, geom, c,
                                                    (H, W, D))

    has_defect = _count(defect) > 0
    nan = torch.full_like(snr, float("nan"))
    ci_val = torch.where(
        has_defect,
        space.masked_sorted_index_sharded(ci_map, defect, c.ci_percentile),
        nan)
    vox_cc = float(np.prod(geom.vox) / 1000.0)
    lung_volume = _nsum([m == 1 for m in ms]) * vox_cc / 1000.0
    defect_volume = _nsum([d == 1 for d in defect]) * vox_cc / 1000.0
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
    if own_slab:
        rows = lambda xs: xs[0]
    else:
        rows = lambda xs: space.gather_rows(xs, devices[0])
    return VentResult(n4=rows(n4), defect=rows(defect),
                      defect_lb=rows(defect_lb), defect_km=rows(defect_km),
                      defect_border=rows(border), ci_map=rows(ci_map),
                      metrics=metrics, export=None)
