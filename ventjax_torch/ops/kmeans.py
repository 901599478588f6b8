"""K-means VDP [Kirby 2012]: Lloyd's iterations on the compacted N4 output.

Counterpart of ``ventjax/ops/kmeans.py``: quantile initialisation, first-of-
ties assignment, early stop once the centers are exactly unchanged.  Each
lane of the batch iterates as if alone: a lane whose centers stopped moving
is frozen while the others go on (the rule ``jax.vmap`` gives the JAX
``while_loop``).  The loop ends when every lane has stopped or after
``iters`` iterations.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ventjax_torch.ops.basic import masked_kth_smallest_multi


def _masked_quantiles(vals: torch.Tensor, m: torch.Tensor,
                      k: int) -> torch.Tensor:
    """[N, k] np.quantile(vals[m>0], (arange(k)+0.5)/k), linear
    interpolation between exactly selected order statistics (float32
    positions, as in ``ventjax``)."""
    n = (m > 0).sum(1)
    qs = (torch.arange(k, device=vals.device, dtype=torch.float32) + 0.5) / k
    pos = qs[None, :] * (n - 1).to(vals.dtype)[:, None]
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    f = pos - lo.to(vals.dtype)
    sel = masked_kth_smallest_multi(vals, m, torch.cat([lo, hi], dim=1))
    return (1 - f) * sel[:, :k] + f * sel[:, k:]


def _assign_first_min(vals: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_j |v - c_j| per value, the lowest j among ties.
    vals [N, P], centers [N, k] -> [N, P] int64."""
    d = (vals[:, :, None] - centers[:, None, :]).abs()
    # torch.argmin does not promise the first index among ties; build it.
    k = centers.shape[1]
    is_min = d == d.min(dim=2, keepdim=True).values
    j = torch.arange(k, device=vals.device)
    return torch.where(is_min, j, k).min(dim=2).values


def vdp_kmeans(
    n4: torch.Tensor,
    mask: torch.Tensor,
    k: int = 4,
    iters: int = 30,
    defect_clusters: int = 1,
    *,
    compacted: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(defect [N,H,W,D] 0/1, VDP_km [N]): the ``defect_clusters``
    lowest-center clusters are defect.

    ``compacted`` = (vals [N, P], wv [N, P]): the masked n4 values, already
    compacted by N4 (``n4_bias_correction(return_compacted=True)``).
    """
    N = n4.shape[0]
    flat = n4.reshape(N, -1).to(torch.float32)
    flat_m = mask.reshape(N, -1) > 0
    vals, wv = compacted
    vals = vals.to(torch.float32)
    wv = wv.to(torch.float32)

    centers = _masked_quantiles(vals, wv, k)
    done = torch.zeros(N, dtype=torch.bool, device=n4.device)
    for _ in range(iters):
        assign = _assign_first_min(vals, centers)
        onehot = assign[:, :, None] == torch.arange(k, device=n4.device)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        sums = torch.where(onehot, (wv * vals)[:, :, None], zero).sum(1)
        counts = torch.where(onehot, wv[:, :, None], zero).sum(1)
        new = torch.where(counts > 0,
                          sums / torch.where(counts > 0, counts, 1.0), centers)
        unchanged = (new == centers).all(1)
        centers = torch.where(done[:, None], centers, new)
        done = done | unchanged
        if bool(done.all()):
            break

    assign_full = _assign_first_min(flat, centers)
    order = torch.argsort(centers, dim=1, stable=True)
    defect_flat = torch.zeros_like(flat)
    for i in range(int(defect_clusters)):
        defect_flat = defect_flat + (assign_full == order[:, i:i + 1]).to(
            flat.dtype)
    defect = (defect_flat * flat_m.to(flat.dtype)).reshape(n4.shape)
    vdp_km = (100.0 * defect.reshape(N, -1).sum(1)
              / mask.reshape(N, -1).sum(1))
    return defect, vdp_km
