"""The work of the port's kernels for one call of the pipeline, counted from
the inputs and from what those inputs need.

The counts are those of the footnote of PERF.md's kernel table and of
``chip_smoke.py``'s records (``k1_record``, ``k2_record``, the K3 bound
with ``k3_box_distances``), restated from the inputs:

- K1 ``fit_moment``: per launch, the rows of each masked voxel (a, and
  ncp values of each of the three basis rows: (1 + 3 ncp) floats) and the
  [ncp, ncp^2] moment out; 2 operations a non-zero product, the products
  being nr * nc * ns a voxel (the non-zero basis entries of its row, column
  and slice: 3 where the spline parameter is a whole number, else 4).
  Each level launches once for the denominator (every study) and once an
  iteration for the numerator, for the studies still iterating.
- K2 ``fit_delta_conv_field``: per iteration and study still iterating,
  (3 ncp + 5) floats a masked voxel and (ncp^3 + 4) a study; 2 operations
  for each of nr * nc * ns + nr * nc + nr terms a voxel.
- K3 ``head_counts``: once a call, the coordinates of each defect voxel as
  center and as witness (6 int32) and ``head_balls`` counts out a center;
  8 float32 operations (three scalings, three squares, two adds) for each
  (center, witness, alias shift) whose offset lies in the rmax box.

Only what the inputs need is counted: masked voxels (not the pad's empty
slots), defect voxels (not the CI pad's sentinel rows), and the studies
that still iterate (not the converged ones the batch carries along).  So
the least time is never above what a kernel that skips nothing must take.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.peaks import least_seconds
from portbench.reference.geometry import alias_combos


def nnz_per_coord(n: int, n_elements: int, device) -> torch.Tensor:
    """[n] non-zero cubic B-spline weights at grid positions 0..n-1 of an
    axis of n voxels with n_elements spans: 3 where the parameter
    i * n_elements / (n - 1) is a whole number, else 4."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    whole = (i * n_elements) % max(n - 1, 1) == 0
    return torch.where(whole, 3, 4).to(torch.float64)


def lane_terms(weights: torch.Tensor, levels: int,
               control_points: int) -> List[Dict[str, torch.Tensor]]:
    """Per level, per study of the [N,H,W,D] 0/1 N4 weights: the masked
    voxel count ``n``, K1's products ``k1`` (sum of nr nc ns) and K2's
    terms ``k2`` (sum of nr nc ns + nr nc + nr)."""
    N, H, W, D = weights.shape
    w = weights.to(torch.float64)
    n = w.reshape(N, -1).sum(1)
    out = []
    for level in range(levels):
        n_el = (control_points - 3) * 2 ** level
        r, c, s = (nnz_per_coord(x, n_el, w.device) for x in (H, W, D))
        rc = torch.einsum("nhws,h,w->n", w, r, c)
        k1 = torch.einsum("nhws,h,w,s->n", w, r, c, s)
        k2 = k1 + rc + torch.einsum("nhws,h->n", w, r)
        out.append({"ncp": n_el + 3, "n": n, "k1": k1, "k2": k2})
    return out


def _iterations(iters: torch.Tensor, level: int) -> List[torch.Tensor]:
    """The studies still iterating at each iteration of a level's loop: the
    loop runs until the slowest study is done."""
    col = iters[:, level]
    return [col > i for i in range(int(col.max()))]


def fit_moment(batch: Dict, spec: Dict) -> float:
    """Least seconds of one call's K1 launches."""
    total = 0.0
    for lv, t in enumerate(batch["terms"]):
        ncp = t["ncp"]
        def launch(on):
            nbytes = float((t["n"][on] * (1 + 3 * ncp) * 4).sum()
                           + on.sum() * ncp ** 3 * 4)
            return least_seconds(nbytes, 2.0 * float(t["k1"][on].sum()))
        total += launch(torch.ones_like(t["n"], dtype=torch.bool))
        total += sum(launch(on) for on in _iterations(batch["iters"], lv))
    return total


def fit_delta_conv_field(batch: Dict, spec: Dict) -> float:
    """Least seconds of one call's K2 launches."""
    total = 0.0
    for lv, t in enumerate(batch["terms"]):
        ncp = t["ncp"]
        for on in _iterations(batch["iters"], lv):
            nbytes = float((t["n"][on] * (3 * ncp + 5) * 4).sum()
                           + on.sum() * (ncp ** 3 + 4) * 4)
            total += least_seconds(nbytes, 2.0 * float(t["k2"][on].sum()))
    return total


def box_distances(defect: torch.Tensor, rmax: int) -> torch.Tensor:
    """[N] (center, witness, alias shift) triples of each study whose
    offset lies in the rmax box, centers and witnesses being its defect
    voxels: for each center and shift, the defect voxels in a box, from a
    summed-volume table."""
    N, H, W, D = defect.shape
    occ = (defect != 0).to(torch.int64)
    sat = torch.zeros((N, H + 1, W + 1, D + 1), dtype=torch.int64,
                      device=defect.device)
    sat[:, 1:, 1:, 1:] = occ.cumsum(1).cumsum(2).cumsum(3)
    out = torch.zeros(N, dtype=torch.float64, device=defect.device)
    for n in range(N):
        v = torch.nonzero(occ[n])                       # [K, 3]
        if v.numel() == 0:
            continue
        for shift in alias_combos((H, W, D)):
            lo, hi = [], []
            for ax, (size, p) in enumerate(zip((H, W, D), shift)):
                lo.append((v[:, ax] - p - rmax).clamp(0, size))
                hi.append((v[:, ax] - p + rmax + 1).clamp(0, size))
            a0, b0, c0 = lo
            a1, b1, c1 = hi
            t = sat[n]
            box = (t[a1, b1, c1] - t[a0, b1, c1] - t[a1, b0, c1]
                   - t[a1, b1, c0] + t[a0, b0, c1] + t[a0, b1, c0]
                   + t[a1, b0, c0] - t[a0, b0, c0])
            out[n] += box.sum().to(torch.float64)
    return out


def head_counts(batch: Dict, spec: Dict) -> float:
    """Least seconds of one call's K3 launch."""
    ns = min(int(spec["head_balls"]), batch["n_balls"] - 1)
    n_def = (batch["defect"] != 0).reshape(batch["defect"].shape[0], -1).sum(1)
    nbytes = float(n_def.sum()) * (6 * 4 + ns * 4)
    flops = 8.0 * float(box_distances(batch["defect"], batch["rmax"]).sum())
    return least_seconds(nbytes, flops)
