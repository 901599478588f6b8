"""The plain reference of the fused study pipeline, in plain PyTorch.

Provenance: a restatement, operation for operation, of the reference
application's formulas (Vent_Analysis.py and CI.py of thomenr/Vent_Analysis
241007_vent; N4 with SimpleITK's defaults) as the port's NumPy oracle
states them (``ventjax_torch/oracle/*.py`` at the commit that added this
benchmark), frozen here and moved to torch so that it runs on the card in
float64.  It imports nothing of the program and takes nothing the program
made: the basis, histogram and sphere tables and the CI geometry are worked
out again in ``geometry.py``.

- ``snr``: CI.py's quirky noise mask (Vent_Analysis.py:337-357).
- ``n4``: N4 on the full voxel grid, every study of the batch iterating as
  if alone (a study stops at its own convergence).  Where a study's
  convergence measure lies within ``band`` (relative) of the threshold, a
  program in float32 may stop on either side of it; the reference then
  follows both outcomes and returns every trajectory with its study.
- ``vdp_mean_anchored``, ``vdp_linear_binning``, ``vdp_kmeans``: the three
  defect maps and VDPs (Vent_Analysis.py:244-261; k-means as the oracle
  states it: quantile start, 30 Lloyd iterations, the lowest cluster).
- ``ci_map``: the per-voxel CV of CI.py by brute force over the sphere table
  (linear-index wraparound, unique witnesses in the numerator, the raw row
  count in the denominator, the first failing ball, saturation at the last
  tested radius), and ``subject_ci``.

The arithmetic precision is the caller's ``dtype``: float64 for the
reference, float32 (with TF32 matrix products on) for the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as G

LOG2 = math.log(2.0)


def _sum(x):
    return x.reshape(x.shape[0], -1).sum(1)


def snr(hp: torch.Tensor, mask: torch.Tensor, fov_buffer: int,
        dtype=torch.float64) -> torch.Tensor:
    """[N] SNR = (mean signal - mean noise) / std noise (population)."""
    out = []
    for a, m in zip(hp.to(dtype), mask > 0):
        H, W, D = m.shape
        dev = m.device
        rows = m.any(2).any(1) * torch.arange(H, device=dev)
        cols = m.any(2).any(0) * torch.arange(W, device=dev)
        cols = torch.arange(int(cols[cols > 0].min()), int(cols.max()),
                            device=dev)
        slcs = m.any(1).any(0) * torch.arange(D, device=dev)
        sel = [torch.zeros(n, dtype=torch.bool, device=dev) for n in (H, W, D)]
        for s, idx in zip(sel, (rows, cols, slcs)):
            s[idx] = True
        noise_mask = ~(sel[0][:, None, None] & sel[1][None, :, None]
                       & sel[2][None, None, :])
        noise_mask[:fov_buffer] = False
        noise_mask[H - fov_buffer:] = False
        noise = a[noise_mask]
        out.append((a[m].mean() - noise.mean()) / noise.std(unbiased=False))
    return torch.stack(out)


def _contract_in(a, br, bc, bs):
    """[A, ncp, ncp, ncp] = sum_hws br[h,c] bc[w,d] bs[s,e] a[A,h,w,s]."""
    t = torch.einsum("ahws,se->ahwe", a, bs)
    t = torch.einsum("ahwe,wd->ahde", t, bc)
    return torch.einsum("ahde,hc->acde", t, br)


def _contract_out(phi, br, bc, bs):
    """[A, H, W, D] = sum_cde br[h,c] bc[w,d] bs[s,e] phi[A,c,d,e]."""
    t = torch.einsum("acde,se->acds", phi, bs)
    t = torch.einsum("acds,wd->acws", t, bc)
    return torch.einsum("acws,hc->ahws", t, br)


def _sharpen(log_u, m, w, bins, fwhm, wiener_noise):
    """ITK's histogram sharpening of each row's masked values ([A, V]):
    the expected true log intensity of every voxel.  A row whose values
    span no range comes back unchanged."""
    dt = log_u.dtype
    inf = torch.full_like(log_u, float("inf"))
    binmin = torch.where(m, log_u, inf).amin(1)
    binmax = torch.where(m, log_u, -inf).amax(1)
    slope = (binmax - binmin) / (bins - 1)
    flat = ~(slope > 0)
    slope = torch.where(flat, torch.ones_like(slope), slope)
    binmin = torch.where(flat, torch.zeros_like(binmin), binmin)
    t = (log_u - binmin[:, None]) / slope[:, None]
    t = torch.where(m, t, torch.zeros_like(t))
    i0f = torch.floor(t)
    f = t - i0f
    i0 = i0f.to(torch.int64).clamp(0, bins - 1)
    i1 = (i0 + 1).clamp(0, bins - 1)
    hist = torch.zeros((log_u.shape[0], bins), dtype=dt, device=log_u.device)
    hist.scatter_add_(1, i0, (1.0 - f) * w)
    hist.scatter_add_(1, i1, f * w)

    padded = G.next_pow2_padded(bins)
    offset = (padded - bins) // 2
    v = F.pad(hist, (offset, padded - bins - offset))
    n = torch.arange(padded, dtype=dt, device=log_u.device)
    half = torch.minimum(n, padded - n)
    scaled_fwhm = fwhm / slope
    exp_factor = 4.0 * LOG2 / scaled_fwhm ** 2
    scale_factor = 2.0 * math.sqrt(LOG2 / math.pi) / scaled_fwhm
    fkernel = scale_factor[:, None] * torch.exp(
        -(half ** 2)[None, :] * exp_factor[:, None])
    ff = torch.fft.fft(fkernel)
    gf = ff.conj() / (ff.abs() ** 2 + wiener_noise)
    u = torch.fft.ifft(torch.fft.fft(v) * gf).real.clamp_min(0.0)
    bin_u = binmin[:, None] + (n - offset)[None, :] * slope[:, None]
    num = torch.fft.ifft(torch.fft.fft(u * bin_u) * ff).real
    den = torch.fft.ifft(torch.fft.fft(u) * ff).real
    expect = torch.where(den != 0, num / torch.where(den != 0, den,
                                                     torch.ones_like(den)),
                         torch.zeros_like(den))
    tt = t + offset
    j0 = torch.floor(tt).clamp(0, padded - 2)
    g = tt - j0
    j0 = j0.to(torch.int64)
    out = (1.0 - g) * expect.gather(1, j0) + g * expect.gather(1, j0 + 1)
    return torch.where(flat[:, None], log_u, out)


def n4(hp: torch.Tensor, mask: torch.Tensor, *, levels: int, max_iters: int,
       threshold: float, bins: int, fwhm: float, wiener_noise: float,
       control_points: int, band: float, dtype=torch.float64,
       max_trajectories: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrected [B,H,W,D], owner [B]): N4 of each study of the [N,H,W,D]
    batch, as one trajectory, or several where the convergence test was
    within ``band`` of its threshold (``owner`` gives each one's study).
    ``max_trajectories`` (default 4 N) caps the branching."""
    N, H, W, D = hp.shape
    dev = hp.device
    cap = max_trajectories or 4 * N
    img = hp.to(dtype).reshape(N, -1)
    m = (mask.reshape(N, -1) > 0) & (img > 0)
    w = m.to(dtype)
    log_in = torch.where(m, torch.log(torch.where(m, img, torch.ones_like(img))),
                         torch.zeros_like(img))
    total = torch.zeros_like(log_in)
    owner = torch.arange(N, device=dev)
    for level in range(levels):
        n_el = (control_points - 3) * 2 ** level
        br, bc, bs = (torch.as_tensor(G.bspline_basis_1d(n, n_el),
                                      dtype=dtype, device=dev)
                      for n in (H, W, D))
        S = ((br ** 2).sum(1)[:, None, None] * (bc ** 2).sum(1)[None, :, None]
             * (bs ** 2).sum(1)[None, None, :]).reshape(-1)
        den = _contract_in(w.reshape(-1, H, W, D), br ** 2, bc ** 2, bs ** 2)
        done = torch.zeros(owner.numel(), dtype=torch.bool, device=dev)
        for _ in range(max_iters):
            act = torch.nonzero(~done).reshape(-1)
            if act.numel() == 0:
                break
            ma, wa = m[act], w[act]
            log_u = log_in[act] - total[act]
            sharp = _sharpen(log_u, ma, wa, bins, fwhm, wiener_noise)
            resid = torch.where(ma, log_u - sharp, torch.zeros_like(log_u))
            a = (wa * resid / S).reshape(-1, H, W, D)
            num = _contract_in(a, br ** 3, bc ** 3, bs ** 3)
            dena = den[act]
            phi = torch.where(dena != 0, num / torch.where(
                dena != 0, dena, torch.ones_like(dena)), torch.zeros_like(num))
            delta = _contract_out(phi, br, bc, bs).reshape(act.numel(), -1)
            total[act] = total[act] + delta
            ed = torch.exp(-delta)
            cnt = wa.sum(1)
            mu = (wa * ed).sum(1) / cnt
            cv = torch.sqrt((wa * (ed - mu[:, None]) ** 2).sum(1) / cnt) / mu
            conv = cv < threshold
            near = (cv - threshold).abs() <= band * threshold
            branch = act[near][:max(0, cap - owner.numel())]
            done[act] = conv
            if branch.numel():
                # the other outcome of a test too close to call
                take = lambda x: torch.cat([x, x[branch]])
                total, log_in, m, w, owner = (take(x) for x in
                                              (total, log_in, m, w, owner))
                den = take(den)
                done = torch.cat([done, ~done[branch]])
    corrected = img[owner] * torch.exp(-total)
    return corrected.reshape(-1, H, W, D), owner


def median3x3(x: torch.Tensor) -> torch.Tensor:
    """Per-slice zero-padded 3x3 median of a 0/1 [N,H,W,D] volume
    (scipy.signal.medfilt2d): at least 5 of the 9 entries are 1."""
    N, H, W, D = x.shape
    p = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    counts = sum(p[:, i:i + H, j:j + W, :] for i in range(3) for j in range(3))
    return (counts >= 5.0).to(torch.float32)


def dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """Per-slice 3x3 dilation of a boolean [N,H,W,D] volume."""
    N, H, W, D = x.shape
    p = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    return sum(p[:, i:i + H, j:j + W, :]
               for i in range(3) for j in range(3)) > 0


def vdp_mean_anchored(n4v, mask, thresh):
    """(defect [N,...] 0/1, VDP [N], undecided [N,...] bool): defect =
    medfilt3x3((n4 / mean(n4[mask]) < thresh) * mask) per slice; undecided
    marks the voxels whose window holds a ratio within 1e-5 (relative) of
    the threshold, which float32 rounding may put on either side."""
    m = mask > 0
    mean = (n4v * m).reshape(n4v.shape[0], -1).sum(1) / _sum(m)
    ratio = n4v / mean[:, None, None, None]
    defect = median3x3((ratio < thresh) & m).to(n4v.dtype)
    tie = m & ((ratio - thresh).abs() <= 1e-5 * thresh)
    return defect, 100.0 * _sum(defect) / _sum(m).to(n4v.dtype), dilate3x3(tie)


def vdp_linear_binning(n4v, mask, edges, percentile):
    """(bin map [N,...] in 1..6 under the mask, VDP_lb [N], undecided):
    n4 over its sorted masked value at index int(count * percentile), in
    six bins; VDP_lb counts bins 1 and 2."""
    m = mask > 0
    lbs, vdps, ties = [], [], []
    for x, mm in zip(n4v, m):
        vals = torch.sort(x[mm]).values
        norm = x / vals[int(vals.numel() * percentile)]
        lb = torch.ones_like(norm)
        tie = torch.zeros_like(mm)
        for e in edges:
            lb = lb + (norm > e).to(lb.dtype)
            tie = tie | ((norm - e).abs() <= 1e-5 * e)
        lb = lb * mm
        lbs.append(lb)
        ties.append(tie & mm)
        vdps.append(100.0 * ((lb == 1) | (lb == 2)).sum().to(x.dtype)
                    / mm.sum().to(x.dtype))
    return torch.stack(lbs), torch.stack(vdps), torch.stack(ties)


def vdp_kmeans(n4v, mask, k, iters, defect_clusters):
    """(defect [N,...] 0/1, VDP_km [N], undecided): Lloyd's algorithm on
    the masked values from the quantiles (arange(k) + 0.5) / k, ``iters``
    iterations, labels from the final centers (the first of equal
    distances); the ``defect_clusters`` lowest clusters are defect.
    Undecided: values within 1e-4 (relative) of the defect boundary."""
    m = mask > 0
    defs, vdps, ties = [], [], []
    qs = (torch.arange(k, dtype=n4v.dtype, device=n4v.device) + 0.5) / k
    for x, mm in zip(n4v, m):
        vals = x[mm]
        centers = torch.quantile(vals, qs)
        for _ in range(iters):
            assign = (vals[:, None] - centers[None, :]).abs().argmin(1)
            for j in range(k):
                sel = assign == j
                if bool(sel.any()):
                    centers[j] = vals[sel].mean()
        assign = (vals[:, None] - centers[None, :]).abs().argmin(1)
        srt = torch.sort(centers).values
        rank = torch.argsort(torch.argsort(centers))
        flag = (rank[assign] < defect_clusters).to(x.dtype)
        d = torch.zeros_like(x)
        d[mm] = flag
        cut = 0.5 * (srt[defect_clusters - 1] + srt[defect_clusters])
        tie = torch.zeros_like(mm)
        tie[mm] = (vals - cut).abs() <= 1e-4 * srt[defect_clusters].abs()
        defs.append(d)
        ties.append(tie)
        vdps.append(100.0 * d.sum() / mm.sum().to(x.dtype))
    return torch.stack(defs), torch.stack(vdps), torch.stack(ties)


def ci_map(defect: torch.Tensor, vox, rmax: int, dtype=torch.float64,
           chunk: int = 256) -> torch.Tensor:
    """[N,H,W,D] CI map of CI.py: per defect voxel, min(vox) times the
    radius of the first ball (in table order, the last ball never tested)
    whose share of defect voxels drops below one half, or the last tested
    radius where none does."""
    N, H, W, D = defect.shape
    dev = defect.device
    px = G.sphere_pixels(tuple(float(v) for v in vox), int(rmax))
    radii, sizes, starts = G.shell_structure(px)
    delta64 = (px[:, 1] + px[:, 2] * H + px[:, 3] * H * W).astype(np.int64)
    _, first = np.unique(delta64, return_index=True)
    is_first = np.zeros(len(delta64), bool)
    is_first[first] = True
    ends = torch.as_tensor(np.cumsum(sizes) - 1, device=dev)
    rows_ball = torch.as_tensor(np.cumsum(sizes), dtype=dtype, device=dev)
    radii_t = torch.as_tensor(radii, dtype=dtype, device=dev)
    delta = torch.as_tensor(delta64, device=dev)
    firsts = torch.as_tensor(is_first, device=dev)
    M = len(radii)
    min_vox = float(np.min(np.asarray(vox, np.float64)))
    # vec(i, j, k) = i + (j - 1) H + (k - 1) HW of CI.py, over a table
    lo = -H - H * W
    span = (H - 1) + (W - 2) * H + (D - 2) * H * W - lo + 1
    out = torch.zeros((N, H, W, D), dtype=dtype, device=dev)
    for n in range(N):
        dv = torch.nonzero(defect[n] != 0)
        if dv.numel() == 0:
            continue
        vec = dv[:, 0] + (dv[:, 1] - 1) * H + (dv[:, 2] - 1) * H * W
        table = torch.zeros(span, dtype=torch.bool, device=dev)
        table[vec - lo] = True
        vals = torch.empty(dv.shape[0], dtype=dtype, device=dev)
        for a in range(0, dv.shape[0], chunk):
            idx = vec[a:a + chunk, None] + delta[None, :] - lo
            inside = (idx >= 0) & (idx < span)
            hit = table[idx.clamp(0, span - 1)] & inside & firsts[None, :]
            cum = torch.cumsum(hit.to(torch.int32), 1)[:, ends]
            failing = (cum.to(dtype) / rows_ball)[:, :M - 1] < 0.5
            j = torch.where(failing.any(1), failing.to(torch.uint8).argmax(1),
                            torch.full_like(failing[:, 0], M - 1,
                                            dtype=torch.int64))
            vals[a:a + chunk] = radii_t[j] * min_vox
        out[n][tuple(dv.T)] = vals
    return out


def subject_ci(ci: torch.Tensor, defect: torch.Tensor,
               percentile: float) -> torch.Tensor:
    """[N] sorted CI over the defect voxels at index int(p * count); NaN
    without defect voxels."""
    out = []
    for c, d in zip(ci, defect != 0):
        vals = torch.sort(c[d]).values
        out.append(vals[int(percentile * vals.numel())] if vals.numel()
                   else torch.tensor(float("nan"), dtype=c.dtype,
                                     device=c.device))
    return torch.stack(out)


def volumes(mask, defect, vox) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lung, defect) volumes in liters from voxel counts."""
    vox_l = float(np.prod(np.asarray(vox, np.float64))) / 1e6
    return _sum(mask == 1).double() * vox_l, _sum(defect == 1).double() * vox_l


def analyze(hp, mask, vox, cfg: Dict, dtype=torch.float64) -> Dict:
    """The whole pipeline on one [N,H,W,D] batch, with the program's
    output names: the maps, and the metrics by StudyMetrics' field names.
    With several N4 trajectories for a study, its first one is kept."""
    n4v, owner = n4(hp, mask, dtype=dtype, band=0.0, **n4_args(cfg))
    first = torch.tensor([int((owner == i).nonzero()[0]) for i in
                          range(hp.shape[0])], device=owner.device)
    n4v = n4v[first]
    defect, vdp, _ = vdp_mean_anchored(n4v, mask, cfg["vdp_thresh"])
    lb, vdp_lb, _ = vdp_linear_binning(n4v, mask, cfg["lb_edges"],
                                       cfg["lb_percentile"])
    km, vdp_km, _ = vdp_kmeans(n4v, mask, cfg["kmeans_clusters"],
                               cfg["kmeans_iters"],
                               cfg["kmeans_defect_clusters"])
    ci = ci_map(defect, vox, cfg["ci_rmax"], dtype)
    lung_l, defect_l = volumes(mask, defect, vox)
    N = hp.shape[0]
    no = torch.zeros(N, dtype=torch.bool, device=hp.device)
    return {"n4": n4v, "defect": defect, "defect_lb": lb, "defect_km": km,
            "ci_map": ci,
            "metrics": {"snr": snr(hp, mask, cfg["snr_fov_buffer"], dtype),
                        "vdp": vdp, "vdp_lb": vdp_lb, "vdp_km": vdp_km,
                        "lung_volume": lung_l, "defect_volume": defect_l,
                        "ci": subject_ci(ci, defect, cfg["ci_percentile"]),
                        "ci_overflow": no, "n4_overflow": no,
                        "valid": ~no}}


def n4_args(cfg: Dict) -> Dict:
    """n4()'s settings from a configuration's pipeline settings."""
    return dict(levels=cfg["n4_fitting_levels"], max_iters=cfg["n4_max_iters"],
                threshold=cfg["n4_convergence_threshold"],
                bins=cfg["n4_histogram_bins"], fwhm=cfg["n4_bias_fwhm"],
                wiener_noise=cfg["n4_wiener_noise"],
                control_points=cfg["n4_control_points"])


__all__: List[str] = ["snr", "n4", "vdp_mean_anchored", "vdp_linear_binning",
                      "vdp_kmeans", "ci_map", "subject_ci", "volumes",
                      "analyze", "n4_args", "median3x3", "dilate3x3"]
