"""Pairwise-distance Cluster-Index engine over a batch of defect maps.

Counterpart of ``ventjax/ops/ci_pairwise.py``.  Ball hit counts are pairwise
statements between defect voxels, and the reference's first-crossing rule
("first ball whose defect fraction drops below 0.5") becomes an
order-statistics test against static thresholds, so the CI map needs only
integer coordinates, float32 distances, counts and one row sort.

The geometry builder and its two exactness guards are numpy, copied from
``ventjax`` (whose module imports JAX); ``ventjax.oracle.ci_oracle`` supplies
the sphere tables.  The resolve runs in two phases, as in ``ventjax``:

- head: per center, counts for the first ``head_balls`` balls through
  kernel K3 (``ops/ci_cuda.py``; its plain version on CPU);
- tail: rows with no head crossing are compacted (stable order) to
  ``tail_k`` lanes and finished by the full sorted-row order statistics.

The dense map is a scatter, or with ``pallas_densify=True`` the rank
lookup of kernels K9 and K8 (``ops/ci_densify_cuda.py``).

Spans (recorded only under a profiler): ``ci.coords``, ``ci.head`` (K3
and the head test), ``ci.tail`` (the compaction and
``ci_pairwise_balls``), ``ci.densify``; each upload of a numpy table is a
pageable copy that waits for the stream, declared as ``ci.sync``.  The
rows K3 and the tail's distance pass run are counted in
``ci_cuda.LAUNCHES``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ventjax_torch.ops.basic import compact_mask_indices
from ventjax_torch.ops.ci_cuda import alias_min_d2, head_counts
from ventjax_torch.ops.ci_densify_cuda import densify_rank, rank
from ventjax_torch.ops.geometry import shell_structure, sphere_pixels
from ventjax_torch.utils.profiling import host_wait, stage

SENT = 1 << 20   # far-away sentinel coordinate: fails every box check


@dataclasses.dataclass(frozen=True)
class CIPairwiseGeometry:
    vox: Tuple[float, float, float]
    rmax: int
    shape: Tuple[int, int, int]
    border_mode: str
    scale: Tuple[float, float, float]   # vox / min(vox), float32-exact
    radii32: np.ndarray                 # [M] float32 ball radii
    r2_32: np.ndarray                   # [M] float32 squared radii
    rows_ball: np.ndarray               # [M] int64 duplicate-inclusive rows
    r2_last: float                      # float32 largest shell r^2
    min_vox: float
    n_balls: int


@functools.lru_cache(maxsize=16)
def build_ci_pairwise_geometry(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    rmax: int = 50,
    border_mode: str = "wrap",
) -> CIPairwiseGeometry:
    """Geometry tables, after proving the engine exact for them.

    Raises ValueError when (a) ball membership is not d^2 <= r^2 or (b)
    float32 distance binning differs from float64 for some box offset.
    """
    vox = tuple(float(v) for v in vox)
    px = sphere_pixels(vox, rmax)
    radii, sizes, _ = shell_structure(px)
    rows_ball = np.cumsum(sizes).astype(np.int64)
    scale64 = np.asarray(vox) / np.min(vox)
    scale32 = scale64.astype(np.float32)
    r2_64 = radii ** 2
    r2_32 = r2_64.astype(np.float32)

    # (a) LUT row shells equal searchsorted(r^2, d^2) except second
    #     occurrences of float-boundary duplicate offsets.
    shell_of_row = np.repeat(np.arange(len(radii)), sizes)
    d2row = ((px[:, 1] * scale64[0]) ** 2 + (px[:, 2] * scale64[1]) ** 2
             + (px[:, 3] * scale64[2]) ** 2)
    pred = np.searchsorted(r2_64, d2row, side="left")
    off = px[:, 1:].astype(np.int64)
    key = ((off[:, 0] + rmax) * (2 * rmax + 1) + (off[:, 1] + rmax)) \
        * (2 * rmax + 1) + (off[:, 2] + rmax)
    _, first_idx = np.unique(key, return_index=True)
    is_first = np.zeros(len(key), bool)
    is_first[first_idx] = True
    if not np.array_equal(pred[is_first], shell_of_row[is_first]):
        raise ValueError(
            "CI pairwise engine: ball membership != d^2<=r^2 for this "
            "geometry; use the gather-ladder engine instead."
        )
    # (b) float32 device arithmetic is bin-exact over every box offset.
    rng = np.arange(-rmax, rmax + 1)
    X, Y, Z = np.meshgrid(rng, rng, rng, indexing="ij")
    d2_64 = ((X * scale64[0]) ** 2 + (Y * scale64[1]) ** 2
             + (Z * scale64[2]) ** 2).ravel()
    dx = X.astype(np.float32) * scale32[0]
    dy = Y.astype(np.float32) * scale32[1]
    dz = Z.astype(np.float32) * scale32[2]
    d2f = (dx * dx + dy * dy + dz * dz).ravel().astype(np.float64)
    if not np.array_equal(
        np.searchsorted(r2_64, d2_64, side="left"),
        np.searchsorted(r2_32.astype(np.float64), d2f, side="left"),
    ):
        raise ValueError(
            "CI pairwise engine: float32 distance binning is not exact for "
            "this geometry; use the gather-ladder engine instead."
        )

    return CIPairwiseGeometry(
        vox=vox,
        rmax=int(rmax),
        shape=tuple(int(s) for s in shape),
        border_mode=border_mode,
        scale=tuple(float(s) for s in scale32),
        radii32=radii.astype(np.float32),
        r2_32=r2_32,
        rows_ball=rows_ball,
        r2_last=float(r2_32[-1]),
        min_vox=float(np.min(np.asarray(vox))),
        n_balls=int(len(radii)),
    )


def _alias_combos(geom: CIPairwiseGeometry):
    """(p, q, s) with p + q*H + s*H*W = 0 and |p| <= H."""
    H, W, _ = geom.shape
    if geom.border_mode == "pad":
        return [(0, 0, 0)]
    return [
        (0, 0, 0),
        (0, W, -1), (0, -W, 1),
        (H, -1, 0), (H, W - 1, -1), (H, -W - 1, 1),
        (-H, 1, 0), (-H, 1 - W, 1), (-H, 1 + W, -1),
    ]


def _upload(table: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A numpy table on ``device``: a pageable copy, which waits for the
    stream, so a declared host wait (``ci.sync``)."""
    with host_wait("ci.sync"):
        return torch.as_tensor(table, dtype=dtype, device=device)


def _threshold_tables(geom: CIPairwiseGeometry, K: int):
    """Static (thr[t], j_lo[t], j_cap) numpy tables for the
    order-statistics test."""
    M = geom.n_balls
    T = (geom.rows_ball + 1) // 2          # fail_j <=> cumcount_j < T_j
    tested = np.arange(M - 1)              # last ball never tested
    t_idx = T[tested] - 1                  # sorted position probed by ball j
    thr = np.full(K, np.inf, np.float32)
    j_lo = np.full(K, M - 1, np.int32)
    for j in tested[::-1]:
        t = t_idx[j]
        if t < K:
            thr[t] = geom.r2_32[j]
            j_lo[t] = j
    over = tested[T[tested] > K]
    j_cap = int(over[0]) if len(over) else M - 1
    return thr, j_lo, j_cap


def _min_d2(centers, witnesses, geom):
    """alias_min_d2 with the last-shell cut: +inf beyond r2_last."""
    d2 = alias_min_d2(centers, witnesses, _alias_combos(geom), geom.scale,
                      geom.rmax)
    return torch.where(d2 <= geom.r2_last, d2, torch.full_like(d2, np.inf))


def ci_pairwise_balls(centers, witnesses, geom: CIPairwiseGeometry,
                      row_chunk: int = 512) -> torch.Tensor:
    """[N, K] first-failing-ball index per center (M-1 = saturated), by
    full order statistics: a sorted row of distances against the static
    thresholds."""
    N, K = centers[0].shape
    nw = witnesses[0].shape[1]
    M = geom.n_balls
    dev = centers[0].device
    thr, j_lo, j_cap = _threshold_tables(geom, nw)
    thr = _upload(thr, dev)
    j_lo = _upload(j_lo, dev, torch.int64)
    out = torch.empty((N, K), dtype=torch.int64, device=dev)
    for a in range(0, K, row_chunk):
        cc = tuple(c[:, a:a + row_chunk] for c in centers)
        srt = torch.sort(_min_d2(cc, witnesses, geom), dim=2).values
        failing = srt > thr
        any_f = failing.any(2)
        tstar = failing.to(torch.uint8).argmax(2)
        j = torch.where(any_f, j_lo[tstar], torch.full_like(tstar, M - 1))
        out[:, a:a + row_chunk] = j.clamp(max=j_cap)
    return out


def resolve_balls_two_phase(
    centers, witnesses, geom: CIPairwiseGeometry, *,
    head_balls: int = 96,
    tail_k: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([N, K] first-failing-ball index, [N] tail overflow).

    Head: K3 counts for the first ``head_balls`` balls; a row resolves
    there if some ball fails (count < T_j).  Tail: unresolved rows are
    compacted, stably and valid rows first, to ``tail_k`` lanes (default
    max(256, K // 8)) and finished by ``ci_pairwise_balls``.  Overflowed
    rows keep the M-1 saturation sentinel; ``valid`` (the real-row mask)
    keeps sentinel padding from counting toward the overflow flag.
    """
    ii, jj, kk = centers
    N, K = ii.shape
    M = geom.n_balls
    dev = ii.device
    ns = min(int(head_balls), M - 1)
    with stage("ci.head"):
        r2 = _upload(geom.r2_32[:ns], dev)
        t_head = _upload(((geom.rows_ball + 1) // 2)[:ns], dev)

        counts = head_counts(centers, witnesses, r2, _alias_combos(geom),
                             geom.scale, geom.rmax)
        fail_head = counts < t_head
        resolved = fail_head.any(2)
        j_head = fail_head.to(torch.uint8).argmax(2)
        jballs = torch.where(resolved, j_head, torch.full_like(j_head, M - 1))

    K2 = int(tail_k) if tail_k is not None else max(256, K // 8)
    K2 = min(K2, K)
    with stage("ci.tail"):
        sel = torch.argsort(resolved.to(torch.uint8), dim=1,
                            stable=True)[:, :K2]
        live = ~resolved.gather(1, sel)
        tail = tuple(
            torch.where(live, g, torch.full_like(g, SENT))
            for g in (c.gather(1, sel) for c in (ii, jj, kk))
        )
        j_tail = ci_pairwise_balls(tail, witnesses, geom,
                                   row_chunk=min(K2, 512))
        jballs = jballs.scatter(
            1, sel, torch.where(live, j_tail, jballs.gather(1, sel)))
    unresolved = ~resolved if valid is None else (~resolved & valid)
    return jballs, unresolved.sum(1) > K2


def defect_coords(defect: torch.Tensor, K: int):
    """The first K defect voxels of each [N,H,W,D] lane as contiguous int32
    coordinate triples [N, K], padding rows at far-away sentinels
    (+SENT for i and k, -SENT for j); also (flat indices, counts, the
    real-row mask)."""
    N, H, W, D = defect.shape
    cidx, n_def = compact_mask_indices((defect != 0).reshape(N, -1), K)
    return coords_of(cidx, n_def, (H, W, D))


def coords_of(cidx: torch.Tensor, n_def: torch.Tensor, shape):
    """``defect_coords`` from the compacted flat indices [N, K] and the
    defect counts [N] of volumes of ``shape``."""
    _, W, D = shape
    K = cidx.shape[1]
    valid = torch.arange(K, device=cidx.device)[None, :] < n_def[:, None]

    def coord(v, fill):
        return torch.where(valid, v, torch.full_like(v, fill)).to(
            torch.int32).contiguous()

    coords = (coord(cidx // (W * D), SENT), coord((cidx // D) % W, -SENT),
              coord(cidx % D, SENT))
    return coords, cidx, n_def, valid


def calculate_ci_pairwise(
    defect: torch.Tensor,
    geom: CIPairwiseGeometry,
    max_defect_voxels: int = 8192,
    head_balls: int = 96,
    tail_k: Optional[int] = None,
    pallas_densify: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(CI map [N,H,W,D] mm, saturated count [N], overflow [N]) for a
    [N,H,W,D] defect batch.  Overflow = more defect voxels than the pad
    ``max_defect_voxels`` or a tail-compaction overflow (the excess rows
    saturate; never silently wrong).

    The dense map is a scatter of the K per-defect values (None or False,
    ventjax's default), or with ``pallas_densify=True`` the rank lookup of
    kernels K9 and K8 (``ops/ci_densify_cuda.py``), which gives the same
    bits at any volume size (ventjax takes its kernels only where
    V % 4096 == 0)."""
    N = defect.shape[0]
    H, W, D = geom.shape
    V = H * W * D
    K = max_defect_voxels
    dev = defect.device
    with stage("ci.coords"):
        coords, cidx, n_def, valid = defect_coords(defect, K)
    cv, n_sat, overflow = ci_pairwise_values(coords, n_def, valid, geom, K,
                                             head_balls, tail_k)
    with stage("ci.densify"):
        if pallas_densify:
            d01 = (defect != 0).reshape(N, V)
            ci_flat = densify_rank(rank(d01), d01, cv, K)
        else:
            ci_flat = torch.zeros((N, V + 1), dtype=torch.float32,
                                  device=dev)
            ci_flat.scatter_(
                1, torch.where(valid, cidx, torch.full_like(cidx, V)), cv)
            ci_flat = ci_flat[:, :V]
    return ci_flat.reshape(N, H, W, D), n_sat, overflow


def ci_pairwise_values(coords, n_def, valid, geom: CIPairwiseGeometry,
                       K: int, head_balls: int = 96,
                       tail_k: Optional[int] = None):
    """(CI value [N, K] of each compacted defect voxel, saturated count
    [N], overflow [N]) from ``defect_coords``' coordinates: the engine
    without the dense map."""
    jballs, tail_overflow = resolve_balls_two_phase(
        coords, coords, geom,
        head_balls=head_balls, tail_k=tail_k, valid=valid)
    saturated = (jballs >= geom.n_balls - 1) & valid
    cv = _upload(geom.radii32, n_def.device)[jballs] * geom.min_vox
    return cv, saturated.sum(1), (n_def > K) | tail_overflow
