"""N4 bias-field correction over a batch of volumes.

Counterpart of ``ventjax/ops/n4.py`` (same algorithm and ITK-default
parameters as the float64 oracle ``ventjax.oracle.n4_oracle``).  Only masked
voxels take part in the iterations, so the loop runs on the compacted
``[N, P]`` masked-voxel vectors with per-voxel B-spline basis rows; the dense
field is evaluated once at the end.

On a card this is ventjax's ``n4_use_pallas=True`` route at every level:
each iteration runs K4 (``sharpen_hist``) -> the expectation's FFT chain
(plain PyTorch, as ventjax keeps it in XLA) -> K5 (``sharpen_resid``) -> K1
(``fit_moment``, the fit numerator) -> K2 (``fit_delta_conv_field``: field
update, next residual, its range, convergence sums), and K1 gives each
level's denominator once.  The dense field is evaluated once at the end,
every level in one launch of the fixed-order field kernel (``n4_field``).
The kernels live in ``ops/n4_sharpen_cuda.py``, ``ops/n4_cuda.py`` and
``ops/n4_field_cuda.py``; on CPU tensors they run their plain versions.
``VentConfig.n4_use_pallas`` is not read: the port has one route, kernels on
CUDA and plain versions on the CPU.  No step sums with float atomics, so two
runs on one card give the same bits.

Each lane iterates as if alone: a lane that has converged is frozen (its
field, coefficients and residual stop changing) while the others go on.
The Python loop stops when every lane is done or at ``max_iters``; checking
``done.all()`` is one device-to-host sync per iteration, counted in
``HOST_SYNCS``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ventjax_torch.ops.basic import sort_compact_masked
from ventjax_torch.ops.geometry import _next_pow2_padded
from ventjax_torch.ops.n4_cuda import fit_delta_conv_field, fit_moment
from ventjax_torch.ops.n4_field_cuda import n4_field
from ventjax_torch.ops.n4_sharpen_cuda import sharpen_hist, sharpen_resid

LOG2 = math.log(2.0)
# Device-to-host syncs made by the level loops since this was set to 0.
HOST_SYNCS = {"n4": 0}


def _sharpen_expectation(hist, binmin, slope, bins, fwhm, wiener_noise,
                         padded, offset):
    """[N, bins+2] slice of ITK's conditional expectation E[u|v] from the
    fractional histogram: Gaussian blur in the padded DFT domain, Wiener
    deconvolution, and the smoothed ratio; the slice holds the entries
    that masked voxels (t + 1 in [1, bins]) can reach."""
    N = hist.shape[0]
    dev = hist.device
    v = torch.zeros((N, padded), dtype=hist.dtype, device=dev)
    v[:, offset:offset + bins] = hist
    n = torch.arange(padded, dtype=hist.dtype, device=dev)
    half = torch.minimum(n, padded - n)
    scaled_fwhm = fwhm / slope
    exp_factor = 4.0 * LOG2 / scaled_fwhm ** 2
    scale_factor = 2.0 * math.sqrt(LOG2 / math.pi) / scaled_fwhm
    fkernel = scale_factor[:, None] * torch.exp(
        -(half ** 2)[None, :] * exp_factor[:, None])
    ff = torch.fft.fft(fkernel)
    gf = ff.conj() / (ff.real * ff.real + ff.imag * ff.imag + wiener_noise)
    u = torch.fft.ifft(torch.fft.fft(v) * gf).real.clamp_min(0.0)
    bin_u = binmin[:, None] + (n - offset)[None, :] * slope[:, None]
    num = torch.fft.ifft(torch.fft.fft(u * bin_u) * ff).real
    den = torch.fft.ifft(torch.fft.fft(u) * ff).real
    nz = den != 0.0
    e = torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                    torch.zeros_like(den))
    return e[:, offset - 1:offset + bins + 1].contiguous()


def _bspline_rows(coords, n, n_elements):
    """[N, P, ncp] cubic B-spline basis rows at integer grid coords:
    the analytic cardinal form B(t - c + 1), equal to the
    ``bspline_basis_1d`` table including its end clamp."""
    ncp = n_elements + 3
    t = coords.to(torch.float32) * (float(n_elements) / float(max(n - 1, 1)))
    c = torch.arange(ncp, dtype=torch.float32, device=coords.device)
    x = torch.abs(t[..., None] - c + 1.0)
    near = (4.0 - 6.0 * x * x + 3.0 * x ** 3) / 6.0
    far = (2.0 - x) ** 3 / 6.0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, zero))


def _rows(bv, power):
    """[N, ncp, P] powered rows, the kernels' layout."""
    return (bv ** power).transpose(1, 2).contiguous()


def _masked_range(logu, wv):
    inf = torch.full_like(logu, float("inf"))
    return (torch.where(wv > 0, logu, inf).min(1).values,
            torch.where(wv > 0, logu, -inf).max(1).values)


def n4_bias_correction(
    image: torch.Tensor,
    mask: torch.Tensor,
    fitting_levels: int = 4,
    max_iters: int = 50,
    convergence_threshold: float = 0.001,
    bins: int = 200,
    fwhm: float = 0.15,
    wiener_noise: float = 0.01,
    control_points: int = 4,
    mask_pad: Optional[int] = None,
    return_field: bool = False,
    return_overflow: bool = False,
    return_iters: bool = False,
    return_phi: bool = False,
    return_compacted: bool = False,
    compacted=None,
):
    """N4-corrected [N,H,W,D] batch (float32).

    mask_pad bounds the masked voxel count per lane (default: the whole
    volume); a lane whose mask exceeds it ignores the excess voxels and
    sets its overflow flag (``return_overflow``).

    ``compacted`` optionally supplies ``(idx, raw_vals, n_mask)`` from
    ``sort_compact_masked`` over the plain mask (mask > 0); the img > 0
    sub-condition then enters through the weights.  The optional outputs
    follow the corrected image in this order: field [N,H,W,D], overflow [N],
    iterations [N, levels], phi [N, sum ncp^3] (the per-level lattices,
    flat, in level order), and (idx, corrected compacted values, mask
    weights) for k-means.
    """
    N, H, W, D = image.shape
    V = H * W * D
    P = V if mask_pad is None else min(int(mask_pad), V)
    img = image.to(torch.float32)
    dev = img.device
    ar = torch.arange(P, device=dev)

    if compacted is None:
        m = (mask > 0) & (img > 0)
        idx, raw_vals, n_mask = sort_compact_masked(
            img.reshape(N, -1), m.reshape(N, -1), P)
        wv = (ar[None, :] < n_mask[:, None]).to(torch.float32)
    else:
        idx, raw_vals, n_mask = compacted
        raw_vals = raw_vals.to(torch.float32)
        wv = ((ar[None, :] < n_mask[:, None]) & (raw_vals > 0)).to(
            torch.float32)
    overflow = n_mask > P

    vals = raw_vals.clamp_min(1.0e-30)
    logv = torch.log(torch.where(wv > 0, vals, torch.ones_like(vals))) * wv
    hc = idx // (W * D)
    wc = (idx // D) % W
    sc = idx % D
    nmask = wv.sum(1)

    padded = _next_pow2_padded(bins)
    offset = (padded - bins) // 2

    field_v = torch.zeros((N, P), dtype=torch.float32, device=dev)
    phi_totals = []
    level_iters = []
    for level in range(fitting_levels):
        n_elements = (control_points - 3) * 2 ** level
        ncp = n_elements + 3
        brv = _bspline_rows(hc, H, n_elements)
        bcv = _bspline_rows(wc, W, n_elements)
        bsv = _bspline_rows(sc, D, n_elements)
        sv = (brv ** 2).sum(2) * (bcv ** 2).sum(2) * (bsv ** 2).sum(2)
        br1, bc1, bs1 = _rows(brv, 1), _rows(bcv, 1), _rows(bsv, 1)
        br3, bc3, bs3 = _rows(brv, 3), _rows(bcv, 3), _rows(bsv, 3)
        den = fit_moment(wv, _rows(brv, 2), _rows(bcv, 2), _rows(bsv, 2))
        den_nz = den != 0.0
        den_safe = torch.where(den_nz, den, torch.ones_like(den))
        del brv, bcv, bsv

        phi_total = torch.zeros((N, ncp, ncp * ncp), dtype=torch.float32,
                                device=dev)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        itc = torch.zeros(N, dtype=torch.int32, device=dev)
        logu = (logv - field_v) * wv
        bmn, bmx = _masked_range(logu, wv)
        for _ in range(max_iters):
            # one slope tensor bins every voxel for K4, the table and K5
            slope = (bmx - bmn) / (bins - 1)
            hist = sharpen_hist(logu, wv, bmn, slope, bins)
            e_loc = _sharpen_expectation(hist, bmn, slope, bins, fwhm,
                                         wiener_noise, padded, offset)
            a = sharpen_resid(logu, wv, sv, e_loc, bmn, slope, bins)
            num = fit_moment(a, br3, bc3, bs3)
            phi = torch.where(den_nz, num / den_safe, torch.zeros_like(num))
            field_v, logu, stats = fit_delta_conv_field(
                phi, br1, bc1, bs1, wv, field_v, logv, done.to(torch.float32))
            s1, s2 = stats[:, 0], stats[:, 1]
            # K4 and K5 read bmn, so it must not be a strided view
            bmn, bmx = stats[:, 2].contiguous(), stats[:, 3]
            # ITK convergence: CV of exp(-delta) over the mask, from the
            # cancellation-free (e^-delta - 1) moments.
            mu = 1.0 + s1 / nmask
            var = ((s2 - s1 * s1 / nmask) / nmask).clamp_min(0.0)
            cv = torch.sqrt(var) / mu
            phi_total = torch.where(done[:, None, None], phi_total,
                                    phi_total + phi)
            itc = itc + (~done).to(torch.int32)
            done = done | (cv < convergence_threshold)
            HOST_SYNCS["n4"] += 1
            if bool(done.all()):
                break
        level_iters.append(itc)
        phi_totals.append(phi_total)

    # Dense field: every level's lattice on the full grid in one kernel
    # (ops/n4_field_cuda.py), each voxel summed in one written order, so a
    # lane's field has the same bits at any batch size.
    phi_flat = torch.cat([p.reshape(N, -1) for p in phi_totals], 1)
    ncps = [(control_points - 3) * 2 ** level + 3
            for level in range(fitting_levels)]
    total_field = n4_field(phi_flat, (H, W, D), ncps)

    corrected = img * torch.exp(-total_field)
    out = (corrected,)
    if return_field:
        out = out + (total_field,)
    if return_overflow:
        out = out + (overflow,)
    if return_iters:
        out = out + (torch.stack(level_iters, dim=1),)
    if return_phi:
        out = out + (phi_flat,)
    if return_compacted:
        corrected_vals = raw_vals * torch.exp(-field_v)
        wv_mask_only = (ar[None, :] < n_mask[:, None]).to(torch.float32)
        out = out + ((idx, corrected_vals, wv_mask_only),)
    return out if len(out) > 1 else out[0]
