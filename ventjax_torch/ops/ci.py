"""Gather-scan Cluster-Index engines over a batch of defect maps.

Counterpart of ``ventjax/ops/ci.py``.  CV(v), the radius of the first
complete-shell ball around v whose defect fraction drops below 0.5, is a
gather from a flat defect indicator at host-precomputed linear-index
offsets, a prefix sum along the offsets and an argmax.  Because the
reference's linear index satisfies vec(v + o) = vec(v) + delta(o), ball
membership (border aliasing and intersect1d uniqueness included) is a
function of the per-(vox, rmax, shape) tables alone.

- ``calculate_ci``: the flat scan over every table row.
- ``calculate_ci_staged``: the stage ladder that ``build_geometry`` falls
  back to where the pairwise engine cannot prove itself exact.  Stage 0
  scans the first rows for every defect voxel; the voxels still unresolved
  are compacted (stable order) into the next stage with their running hit
  count, so the result equals the flat scan's.

Border modes: "wrap" reproduces the reference's index aliasing at the
volume border; "pad" zero-pads the volume instead.

Both take a [N,H,W,D] batch; the lanes are independent, and each loop over
defect chunks keeps a [N, chunk, rows] gather under ``CHUNK_ELEMS``
elements (``chunk_elems`` for the ladder, as in ventjax).  The sums count
0/1 values in float32, so they are exact and the maps equal ventjax's bit
for bit.  There is no hand-written kernel here:
ventjax has no Pallas kernel for this engine either, and gathers, cumsum
and argmax are what the card's own PyTorch operators do well.

The geometry builder is numpy, copied from ``ventjax`` (whose module imports
JAX); ``ventjax.oracle.ci_oracle`` supplies the sphere tables.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ventjax_torch.ops.basic import compact_mask_indices
from ventjax_torch.ops.geometry import shell_structure, sphere_pixels

# Elements of one [N, chunk, rows] gather (float32: 16 MiB, with its int64
# targets 48 MiB more).
CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class CIGeometry:
    """Host-precomputed CI tables for one (vox, rmax, shape, border_mode)."""
    vox: Tuple[float, float, float]
    rmax: int
    shape: Tuple[int, int, int]
    border_mode: str
    delta: np.ndarray        # [U] int32 linear-index delta per LUT row
    first_occ: np.ndarray    # [U] bool: first occurrence of each delta value
    shell_ends: np.ndarray   # [M] int32 cumulative row count per ball
    radii: np.ndarray        # [M] float32 ball radii (scaled-voxel units)
    flat_len: int            # length of the flat indicator array
    pads: Tuple[int, int, int]  # zero-pad widths per axis ("pad" mode only)
    min_vox: float


@functools.lru_cache(maxsize=16)
def build_ci_geometry(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    rmax: int = 50,
    border_mode: str = "wrap",
) -> CIGeometry:
    H, W, D = shape
    px = sphere_pixels(vox, rmax)
    radii, sizes, _ = shell_structure(px)
    di = px[:, 1].astype(np.int64)
    dj = px[:, 2].astype(np.int64)
    dk = px[:, 3].astype(np.int64)

    if border_mode == "wrap":
        # Reference linear indexing vec(i,j,k) = i + (j-1)H + (k-1)HW,
        # shifted onto Fortran-order flat indices in [0, H*W*D): aliased
        # out-of-bounds sphere voxels land where the reference's px2vec
        # puts them.
        delta = di + dj * H + dk * H * W
        flat_len = H * W * D
        pads = (0, 0, 0)
    elif border_mode == "pad":
        # Zero-padded flat volume: distinct offsets never collide.
        pr, pc, ps = (int(np.abs(x).max()) for x in (di, dj, dk))
        Hp, Wp, Dp = H + 2 * pr, W + 2 * pc, D + 2 * ps
        delta = di + dj * Hp + dk * Hp * Wp
        flat_len = Hp * Wp * Dp
        pads = (pr, pc, ps)
    else:
        raise ValueError(f"unknown border_mode {border_mode!r}")

    # intersect1d uniqueness: duplicates of a delta count once (CI.py:96).
    _, first_idx = np.unique(delta, return_index=True)
    first_occ = np.zeros(len(delta), dtype=bool)
    first_occ[first_idx] = True

    return CIGeometry(
        vox=tuple(float(v) for v in vox),
        rmax=int(rmax),
        shape=(H, W, D),
        border_mode=border_mode,
        delta=delta.astype(np.int32),
        first_occ=first_occ,
        shell_ends=np.cumsum(sizes).astype(np.int32),
        radii=radii.astype(np.float32),
        flat_len=int(flat_len),
        pads=pads,
        min_vox=float(np.min(np.asarray(vox))),
    )


def _flat_indicator(d01: torch.Tensor, geom: CIGeometry) -> torch.Tensor:
    """[N, flat_len] float32 defect indicator in Fortran order (i fastest),
    zero-padded in "pad" mode."""
    x = d01.to(torch.float32)
    if geom.border_mode == "pad":
        pr, pc, ps = geom.pads
        x = torch.nn.functional.pad(x, (ps, ps, pc, pc, pr, pr))
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


def _defect_bases(d01: torch.Tensor, geom: CIGeometry, K: int):
    """The first K defect voxels of each lane in C order: (flat indices
    [N, K], counts [N], the real-slot mask [N, K], their Fortran-order base
    index into the flat indicator [N, K], 0 in padding slots)."""
    N = d01.shape[0]
    H, W, D = geom.shape
    V = H * W * D
    cidx, n_def = compact_mask_indices(d01.reshape(N, V), min(K, V))
    if K > V:
        cidx = torch.cat([cidx, cidx.new_full((N, K - V), V - 1)], dim=1)
    valid = torch.arange(K, device=d01.device)[None, :] < n_def[:, None]
    ii = cidx // (W * D)
    jj = (cidx // D) % W
    kk = cidx % D
    if geom.border_mode == "wrap":
        base = ii + jj * H + kk * H * W
    else:
        pr, pc, ps = geom.pads
        Hp, Wp = H + 2 * pr, W + 2 * pc
        base = (ii + pr) + (jj + pc) * Hp + (kk + ps) * Hp * Wp
    return cidx, n_def, valid, torch.where(valid, base, torch.zeros_like(base))


def _prefix_hits(flat, bases, delta, weight, L):
    """[N, c, rows] running count of distinct defect hits along the LUT
    rows ``delta`` around each base (out-of-range targets count 0)."""
    N = flat.shape[0]
    tgt = bases[:, :, None] + delta[None, None, :]
    ok = (tgt >= 0) & (tgt < L)
    vals = flat.gather(1, tgt.clamp(0, L - 1).reshape(N, -1)).reshape(
        tgt.shape)
    return torch.cumsum(vals * ok.to(torch.float32) * weight, dim=2)


def _dense_map(cidx, valid, cv, geom: CIGeometry) -> torch.Tensor:
    """Scatter the per-defect values into a [N,H,W,D] map (0 elsewhere)."""
    N = cidx.shape[0]
    V = int(np.prod(geom.shape))
    flat = torch.zeros((N, V + 1), dtype=torch.float32, device=cidx.device)
    flat.scatter_(1, torch.where(valid, cidx, torch.full_like(cidx, V)), cv)
    return flat[:, :V].reshape((N,) + tuple(geom.shape))


def _tables(geom: CIGeometry, dev, a: int = 0, b=None):
    delta = torch.as_tensor(geom.delta[a:b], dtype=torch.int64, device=dev)
    weight = torch.as_tensor(geom.first_occ[a:b], dtype=torch.float32,
                             device=dev)
    return delta, weight


def calculate_ci(
    defect: torch.Tensor,
    geom: CIGeometry,
    max_defect_voxels: int = 8192,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(CI map [N,H,W,D] float32 mm, saturated count [N], overflow [N]) by
    the flat scan over every LUT row.

    Saturated voxels never crossed below the defect-fraction threshold (the
    reference raises ValueError there, CI.py:101-104) and keep the last
    ball's radius; overflow flags more defect voxels than the pad
    ``max_defect_voxels`` (the excess voxels get no CI value)."""
    N = defect.shape[0]
    K = max_defect_voxels
    dev = defect.device
    d01 = defect != 0
    flat = _flat_indicator(d01, geom)
    cidx, n_def, valid, base = _defect_bases(d01, geom, K)
    delta, weight = _tables(geom, dev)
    ends = torch.as_tensor(geom.shell_ends, dtype=torch.int64, device=dev)
    radii = torch.as_tensor(geom.radii, device=dev)
    rows_ball = ends.to(torch.float32)
    M = int(geom.shell_ends.shape[0])
    ck = max(1, min(chunk, CHUNK_ELEMS // max(N * len(geom.delta), 1)))
    cv = torch.empty((N, K), dtype=torch.float32, device=dev)
    any_fail = torch.empty((N, K), dtype=torch.bool, device=dev)
    for a in range(0, K, ck):
        cum = _prefix_hits(flat, base[:, a:a + ck], delta, weight,
                           geom.flat_len)
        frac = cum[:, :, ends - 1] / rows_ball
        failing = frac[:, :, :M - 1] < 0.5
        fail = failing.any(2)
        jstar = failing.to(torch.uint8).argmax(2)
        cv[:, a:a + ck] = torch.where(fail, radii[jstar], radii[M - 1])
        any_fail[:, a:a + ck] = fail
    saturated = ~any_fail & valid
    ci_map = _dense_map(cidx, valid, cv * geom.min_vox, geom)
    return ci_map, saturated.sum(1), n_def > K


def _snap_stage_rows(geom: CIGeometry, stage_rows) -> list:
    """Snap requested stage row boundaries to complete-ball row counts."""
    ends = geom.shell_ends
    U = int(ends[-1])
    snapped = [int(ends[np.searchsorted(ends, r)]) for r in stage_rows
               if r < U] + [U]
    out = []
    for r in snapped:
        if not out or r > out[-1]:
            out.append(r)
    return out


def calculate_ci_staged(
    defect: torch.Tensor,
    geom: CIGeometry,
    max_defect_voxels: int = 8192,
    stage_rows: Tuple[int, ...] = (640, 4096, 16384),
    stage_k: Tuple[int, ...] = (2048, 512, 256),
    chunk_elems: int = CHUNK_ELEMS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-laddered exact CI, the same map as ``calculate_ci`` with far
    less gather work: almost every defect voxel crosses within the first
    few hundred LUT rows, so only the unresolved ones scan further.

    Stage boundaries are snapped to complete-ball row counts, so the first
    crossing is found in the same order.  ``stage_k[i]`` bounds the voxels
    per lane that continue into stage i+1; the excess stay saturated and
    are counted in the returned stage overflow (flagged, never silently
    wrong; a larger ``stage_k`` re-runs them exactly).

    Returns (ci_map [N,H,W,D], saturated [N], defect overflow [N], stage
    overflow [N] int32).
    """
    N = defect.shape[0]
    K = max_defect_voxels
    dev = defect.device
    d01 = defect != 0
    flat = _flat_indicator(d01, geom)
    cidx, n_def, valid, base = _defect_bases(d01, geom, K)

    ends_np = geom.shell_ends
    M = int(ends_np.shape[0])
    rows_snapped = _snap_stage_rows(geom, stage_rows)
    n_stages = len(rows_snapped)
    stage_ks = [K] + [min(int(k), K) for k in stage_k][:n_stages - 1]
    stage_ks += [stage_ks[-1]] * (n_stages - len(stage_ks))

    resolved = ~valid
    cv_ball = torch.full((N, K), M - 1, dtype=torch.int64, device=dev)
    hits = torch.zeros((N, K), dtype=torch.float32, device=dev)
    stage_overflow = torch.zeros(N, dtype=torch.int32, device=dev)

    a = 0
    for b, Ks in zip(rows_snapped, stage_ks):
        # Ball ends inside (a, b]; the global last ball is never tested
        # (CI.py:92-99).
        in_stage = np.nonzero((ends_np > a) & (ends_np <= b))[0]
        in_stage = in_stage[in_stage < M - 1]
        ends_rel = torch.as_tensor(ends_np[in_stage] - a - 1,
                                   dtype=torch.int64, device=dev)
        balls = torch.as_tensor(in_stage, dtype=torch.int64, device=dev)
        denom = torch.as_tensor(ends_np[in_stage], dtype=torch.float32,
                                device=dev)
        delta, weight = _tables(geom, dev, a, b)

        if a == 0:
            sel = torch.arange(K, device=dev).expand(N, K)
        else:
            # Stable sort: unresolved lanes first, in their original order.
            sel = torch.argsort(resolved.to(torch.uint8), dim=1,
                                stable=True)[:, :Ks]
            n_unres = (~resolved).sum(1).to(torch.int32)
            stage_overflow += (n_unres - Ks).clamp(min=0)
        bases_s = base.gather(1, sel)
        carry_s = hits.gather(1, sel)
        live_s = ~resolved.gather(1, sel)

        found = torch.zeros((N, Ks), dtype=torch.bool, device=dev)
        ball_g = torch.zeros((N, Ks), dtype=torch.int64, device=dev)
        new_hits = torch.empty((N, Ks), dtype=torch.float32, device=dev)
        ck = max(1, min(Ks, chunk_elems // max(N * (b - a), 1)))
        for c in range(0, Ks, ck):
            cum = carry_s[:, c:c + ck, None] + _prefix_hits(
                flat, bases_s[:, c:c + ck], delta, weight, geom.flat_len)
            new_hits[:, c:c + ck] = cum[:, :, -1]
            if len(in_stage):
                failing = (cum[:, :, ends_rel] / denom) < 0.5
                found[:, c:c + ck] = failing.any(2) & live_s[:, c:c + ck]
                ball_g[:, c:c + ck] = balls[failing.to(torch.uint8).argmax(2)]

        # Scatter the stage's results back into the lanes they came from.
        cv_ball = cv_ball.scatter(
            1, sel, torch.where(found, ball_g, cv_ball.gather(1, sel)))
        hits = hits.scatter(
            1, sel, torch.where(live_s, new_hits, carry_s))
        resolved = resolved.scatter(1, sel, ~live_s | found)
        a = b

    # Unresolved lanes (true rmax saturation or stage overflow) keep the
    # saturated default; the stage overflow tells the two apart.
    saturated = ~resolved & valid
    cv = torch.as_tensor(geom.radii, device=dev)[cv_ball] * geom.min_vox
    return (_dense_map(cidx, valid, cv, geom), saturated.sum(1), n_def > K,
            stage_overflow)
