"""N4 bias-field correction of volumes held in H-slabs (the space axis).

The slab program of ``ops/n4.py``'s ``n4_bias_correction``, for
``pipeline/spatial.py``.  Each lane's masked voxels form one global
compacted list (row-major order, at most ``mask_pad`` entries); slab s
holds one contiguous run of it.  The list is cut into K1's and K2's chunks
(``n4_cuda.CHUNK`` entries) and every chunk is owned by the slab that holds
its first entry: that slab receives the chunk's tail from the next slabs
once, before the first level (``dist.space.chunk_layout``), and from then
on keeps the N4 state of its owned chunks.  Every iteration then runs, per
slab:

- K4's first phase (``sharpen_hist_partial``); the slabs' int64 partials,
  concatenated along the chunk axis, go through one ``sharpen_hist_finish``
  (integers add exactly in any order: the unsharded histogram's bits);
- the expectation table, once, replicated (it is [N, bins + 2]);
- K5 on the slab;
- K1's first phase (``fit_moment_partial``) over the slab's owned chunks;
  the partials of every slab, in chunk order, go through one
  ``fit_moment_reduce``: the unsharded moment's bits;
- phi, replicated; K2 on the slab with its per-chunk statistics, folded
  across slabs by ``fit_fold_stats`` in chunk order;
- the convergence test and ``done``, replicated: one host sync for the
  whole mesh per iteration (``HOST_SYNCS``), under ``ops/n4.py``'s span
  names (``n4.level``, ``n4.iter``, ``n4.sync``).

The dense field is evaluated per slab on its own rows (``n4_field`` with
``rows``).  On a card the kernels' bits do not depend on where a chunk
lies in a launch, so the slabs give the unsharded run's corrected image bit
for bit; on the CPU the plain versions sum chunk by chunk where the
unsharded plain versions sum the whole list at once, which agrees within
float32 rounding.

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
from ventjax_torch.ops.geometry import _next_pow2_padded
from ventjax_torch.ops.n4 import (
    HOST_SYNCS, _bspline_rows, _masked_range, _rows, _sharpen_expectation,
)
from ventjax_torch.ops.n4_cuda import (
    CHUNK, fit_delta_conv_field, fit_fold_stats, fit_moment_partial,
    fit_moment_reduce,
)
from ventjax_torch.ops.n4_field_cuda import n4_field
from ventjax_torch.ops.n4_sharpen_cuda import (
    sharpen_hist_finish, sharpen_hist_partial, sharpen_resid,
)
from ventjax_torch.utils.profiling import host_wait, stage


def _moment(a_bufs, rows):
    """K1 over the slabs: partials per slab, one chunk-order reduce."""
    parts = [fit_moment_partial(a, *r) for a, r in zip(a_bufs, rows)]
    return fit_moment_reduce(space.cat_chunks(parts))


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
    devs = [x.device for x in img]
    N = img[0].shape[0]
    dev0 = devs[0]
    h = img[0].shape[1]

    n_mask = space.sum_int([r[2] for r in runs])
    overflow = n_mask > P
    cap = torch.clamp(n_mask, max=P)
    layout = space.chunk_layout([r[2] for r in runs],
                                [r[0].shape[1] for r in runs], cap, CHUNK)
    idx = space.gather_owned([r[0] for r in runs], layout, fill=V - 1)
    raw = space.gather_owned([r[1].to(torch.float32) for r in runs], layout)
    live = [v.to(torch.float32) for v in layout.valid]
    wv = [((v > 0) & (r > 0)).to(torch.float32)
          for v, r in zip(layout.valid, raw)]
    logv = [torch.log(torch.where(w > 0, r.clamp_min(1.0e-30),
                                  torch.ones_like(r))) * w
            for w, r in zip(wv, raw)]
    coords = [(i // (W * D), (i // D) % W, i % D) for i in idx]
    nmask = space.sum_in_order([w.sum(1) for w in wv])

    padded = _next_pow2_padded(bins)
    offset = (padded - bins) // 2

    field_v = [torch.zeros_like(w) for w in wv]
    phi_totals, level_iters = [], []
    for level in range(fitting_levels):
        with stage("n4.level"):
            n_elements = (control_points - 3) * 2 ** level
            ncp = n_elements + 3
            r1, r2, r3, sv = [], [], [], []
            for hc, wc, sc in coords:
                b = (_bspline_rows(hc, H, n_elements),
                     _bspline_rows(wc, W, n_elements),
                     _bspline_rows(sc, D, n_elements))
                sv.append((b[0] ** 2).sum(2) * (b[1] ** 2).sum(2)
                          * (b[2] ** 2).sum(2))
                r1.append(tuple(_rows(x, 1) for x in b))
                r2.append(tuple(_rows(x, 2) for x in b))
                r3.append(tuple(_rows(x, 3) for x in b))
            den = _moment(wv, r2)
            del r2
            den_nz = den != 0.0
            den_safe = torch.where(den_nz, den, torch.ones_like(den))

            phi_total = torch.zeros((N, ncp, ncp * ncp),
                                    dtype=torch.float32, device=dev0)
            done = torch.zeros(N, dtype=torch.bool, device=dev0)
            itc = torch.zeros(N, dtype=torch.int32, device=dev0)
            logu = [(lv - f) * w for lv, f, w in zip(logv, field_v, wv)]
            rng = [_masked_range(lu, w) for lu, w in zip(logu, wv)]
            bmn = space.reduce_min([r[0] for r in rng])
            bmx = space.reduce_max([r[1] for r in rng])
            for _ in range(max_iters):
                with stage("n4.iter"):
                    slope = (bmx - bmn) / (bins - 1)
                    rep = [(space.to(bmn, d), space.to(slope, d))
                           for d in devs]
                    hist = sharpen_hist_finish(space.cat_chunks([
                        sharpen_hist_partial(lu, w, mn, sl, bins)
                        for lu, w, (mn, sl) in zip(logu, wv, rep)]), bins)
                    e_loc = _sharpen_expectation(hist, bmn, slope, bins,
                                                 fwhm, wiener_noise, padded,
                                                 offset)
                    a = [sharpen_resid(lu, w, v, space.to(e_loc, d), mn, sl,
                                       bins)
                         for lu, w, v, d, (mn, sl)
                         in zip(logu, wv, sv, devs, rep)]
                    num = _moment(a, r3)
                    phi = torch.where(den_nz, num / den_safe,
                                      torch.zeros_like(num))
                    donef = done.to(torch.float32)
                    outs = [fit_delta_conv_field(space.to(phi, d), *r, w, f,
                                                 lv, space.to(donef, d),
                                                 return_part=True)
                            for d, r, w, f, lv
                            in zip(devs, r1, wv, field_v, logv)]
                    field_v = [o[0] for o in outs]
                    logu = [o[1] for o in outs]
                    stats = fit_fold_stats(space.cat_chunks(
                        [o[3] for o in outs]))
                    s1, s2 = stats[:, 0], stats[:, 1]
                    bmn, bmx = stats[:, 2].contiguous(), stats[:, 3]
                    mu = 1.0 + s1 / nmask
                    var = ((s2 - s1 * s1 / nmask) / nmask).clamp_min(0.0)
                    cv = torch.sqrt(var) / mu
                    phi_total = torch.where(done[:, None, None], phi_total,
                                            phi_total + phi)
                    itc = itc + (~done).to(torch.int32)
                    done = done | (cv < convergence_threshold)
                    HOST_SYNCS["n4"] += 1
                    with host_wait("n4.sync"):
                        if bool(done.all()):
                            break
        level_iters.append(itc)
        phi_totals.append(phi_total)
        del r1, r3, sv

    phi_flat = torch.cat([p.reshape(N, -1) for p in phi_totals], 1)
    ncps = [(control_points - 3) * 2 ** level + 3
            for level in range(fitting_levels)]
    corrected: List[torch.Tensor] = []
    for s, x in space.numbered(img):
        d = x.device
        field = n4_field(space.to(phi_flat, d), (H, W, D), ncps,
                         rows=(s * h, (s + 1) * h))
        corrected.append(x.to(torch.float32) * torch.exp(-field))
    vals = [r * torch.exp(-f) for r, f in zip(raw, field_v)]
    comp = (space.gather_runs(idx, layout.counts, P, fill=V - 1),
            space.gather_runs(vals, layout.counts, P),
            space.gather_runs(live, layout.counts, P))
    return corrected, overflow, torch.stack(level_iters, dim=1), comp
