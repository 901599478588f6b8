"""N4 bias-field correction of volumes held in H-slabs (the space axis).

The slab program of ``ops/n4.py``'s ``n4_bias_correction``, for
``pipeline/spatial.py``: the same level loop (``n4.level_loop``) over a
list held in slabs.  Each lane's masked voxels form one global compacted
list (row-major order, at most ``mask_pad`` entries); slab s holds one
contiguous run of it.  The list is cut into K1's and K2's chunks
(``n4_cuda.CHUNK`` entries) and every chunk is owned by the slab that holds
its first entry: that slab receives the chunk's tail from the next slabs
once, before the first level (``dist.space.chunk_layout``), and from then
on keeps the N4 state of its owned chunks.  What this module adds to the
loop is how the slabs' partials become each lane's values (``_Slabs``):

- K4's first phase (``sharpen_hist_partial``) on every slab; the slabs'
  int64 partials, concatenated along the chunk axis, go through one
  ``sharpen_hist_finish`` (integers add exactly in any order: the
  unsharded histogram's bits);
- K1's first phase (``fit_moment_partial``) over each slab's owned chunks;
  the partials of every slab, in chunk order, go through one
  ``fit_moment_reduce``: the unsharded moment's bits;
- K2 on every slab with its per-chunk statistics, folded across slabs by
  ``fit_fold_stats`` in chunk order;
- the lanes' mask counts and initial ranges, added and compared in slab
  order.

The expectation table, phi, the convergence test and ``done`` are computed
once, replicated on the first slab's device, and K5 runs on every slab:
one host sync for the whole mesh per iteration.  The dense field is
evaluated per slab on its own rows (``n4_field`` with ``rows``).  On a card
the kernels' bits do not depend on where a chunk lies in a launch, so the
slabs give the unsharded run's corrected image bit for bit; on the CPU the
plain versions sum chunk by chunk where the unsharded plain versions sum
the whole list at once, which agrees within float32 rounding.

Over ranks (``dist.space.on_ranks``, one slab a rank of a batch row's
group) the same program runs with each rank's one slab: the chunk tails
travel once, before the first level; every iteration all_gathers K4's,
K1's and K2's per-chunk partials in slab order and every rank reduces
them in chunk order, so the histogram, phi, the statistics and ``done``
are replicated bit for bit and every rank of the row takes the same
branch at the convergence test.  Every collective uses the row's group
only: rows converge in different numbers of iterations.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ventjax_torch.dist import space
from ventjax_torch.ops.n4 import level_loop, n4_ncps
from ventjax_torch.ops.n4_cuda import (
    CHUNK, fit_delta_conv_field, fit_fold_stats, fit_moment_partial,
    fit_moment_reduce,
)
from ventjax_torch.ops.n4_field_cuda import n4_field
from ventjax_torch.ops.n4_sharpen_cuda import (
    sharpen_hist_finish, sharpen_hist_partial,
)


class _Slabs:
    """The level loop's combiner for slabs (see the module's docstring)."""

    total = staticmethod(space.sum_in_order)
    low = staticmethod(space.reduce_min)
    high = staticmethod(space.reduce_max)

    @staticmethod
    def hist(args, bins):
        return sharpen_hist_finish(space.cat_chunks([
            sharpen_hist_partial(*a, bins) for a in args]), bins)

    @staticmethod
    def moment(args):
        return fit_moment_reduce(space.cat_chunks([
            fit_moment_partial(*a) for a in args]))

    @staticmethod
    def fit(args):
        outs = [fit_delta_conv_field(*a, return_part=True) for a in args]
        return ([o[0] for o in outs], [o[1] for o in outs],
                fit_fold_stats(space.cat_chunks([o[3] for o in outs])))


def n4_slabs(
    img: Sequence[torch.Tensor],
    runs,
    shape,
    mask_pad: int,
    fitting_levels: int = 4,
    max_iters: int = 50,
    convergence_threshold: float = 0.001,
    bins: int = 200,
    fwhm: float = 0.15,
    wiener_noise: float = 0.01,
    control_points: int = 4,
):
    """N4 over the slabs ``img`` ([N, h, W, D] each, slab s on its device).

    ``runs[s] = (idx, raw, count)``: slab s's compacted mask voxels, global
    flat indices and raw values [N, P_s] in row-major order and the count
    of its mask voxels [N] (all of them; entries past the global pad are
    dropped here).  ``shape`` is the global (H, W, D); ``mask_pad`` the
    global list's pad P.

    Returns (corrected slabs, overflow [N], iterations [N, levels], the
    global compacted list (idx, corrected values, mask weights) [N, P] on
    the first slab's device, as ``n4_bias_correction(return_compacted=
    True)`` gives it up to its padding slots)."""
    H, W, D = (int(x) for x in shape)
    V = H * W * D
    P = min(int(mask_pad), V)
    N, h = img[0].shape[:2]

    n_mask = space.sum_int([r[2] for r in runs])
    overflow = n_mask > P
    cap = torch.clamp(n_mask, max=P)
    layout = space.chunk_layout([r[2] for r in runs],
                                [r[0].shape[1] for r in runs], cap, CHUNK)
    idx = space.gather_owned([r[0] for r in runs], layout, fill=V - 1)
    raw = space.gather_owned([r[1].to(torch.float32) for r in runs], layout)
    ncps = n4_ncps(fitting_levels, control_points)
    phi_totals, level_iters, vals = level_loop(
        _Slabs, list(zip(idx, raw, layout.valid)), (H, W, D), ncps,
        max_iters, convergence_threshold, bins, fwhm, wiener_noise,
        corrected=True)

    phi_flat = torch.cat([p.reshape(N, -1) for p in phi_totals], 1)
    corrected: List[torch.Tensor] = []
    for s, x in space.numbered(img):
        d = x.device
        field = n4_field(space.to(phi_flat, d), (H, W, D), ncps,
                         rows=(s * h, (s + 1) * h))
        corrected.append(x.to(torch.float32) * torch.exp(-field))
    live = [v.to(torch.float32) for v in layout.valid]
    comp = (space.gather_runs(idx, layout.counts, P, fill=V - 1),
            space.gather_runs(vals, layout.counts, P),
            space.gather_runs(live, layout.counts, P))
    return corrected, overflow, torch.stack(level_iters, dim=1), comp
