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

An iteration reads and writes only its level's slots, all views into one
allocation of the call, laid out for the finest level (each of the six
basis-row tensors a prefix of its slot at coarser levels) and freed when
the loop ends.  On a card an iteration is one CUDA graph replay, not ~50
launches.  A level whose signature (device, stream, N, P, ncp, the finest
ncp, bins, the loop's float parameters and the address of the call's
slots) has a graph kept replays it for every iteration.  Otherwise its
first iteration runs eagerly on a capture stream and is captured there
(``torch.cuda.CUDAGraph``), and the level's other iterations replay it.
Once the caching allocator is warm a call of the same shapes gets its
allocation back at an address it had before, so later calls only replay.
A replay runs the same kernels in the same order on the same stream, so
it gives the eager loop's bits, and adds the captured iteration's launches
to ``LAUNCHES``.  ``GRAPHS_KEPT`` signatures are kept, the one used
longest ago dropped first.  A graph keeps alive K2's ticket buffer it was
captured on (``n4_cuda._tickets``, replaced when a larger batch comes).
The graphs of a device and stream share one memory pool, which holds the
iterations' scratch; the caching allocator counts it as reserved, not as
allocated (``graph_pool_bytes``).  CPU tensors, and a call made while a
capture is under way, run every iteration eagerly.  ``n4_cuda.LAUNCHES``
counts captures and replays (``n4_iter_graph_captures``,
``n4_iter_graph_replays``).

Spans (``utils/profiling.stage``, recorded only under a profiler): one
``n4.level`` a fitting level (its basis rows and K1's denominator), inside
it one ``n4.iter`` an iteration holding ``n4.sharpen`` (K4, the
expectation chain, K5), ``n4.fit`` (K1, K2, the CV arithmetic) and
``n4.sync`` (the wait on ``done.all()``); a replayed iteration holds only
``n4.sync``, an iteration that captures also ``n4.capture``; then
``n4.field`` (the dense field and ``exp``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
import threading
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ventjax_torch.ops import n4_cuda, n4_sharpen_cuda
from ventjax_torch.ops.basic import sort_compact_masked
from ventjax_torch.ops.geometry import _next_pow2_padded
from ventjax_torch.ops.n4_cuda import fit_delta_conv_field, fit_moment
from ventjax_torch.ops.n4_field_cuda import n4_field
from ventjax_torch.ops.n4_sharpen_cuda import sharpen_hist, sharpen_resid
from ventjax_torch.oracle.n4_oracle import bspline_basis_1d
from ventjax_torch.utils.profiling import host_wait, stage

LOG2 = math.log(2.0)
# Device-to-host syncs made by the level loops since this was set to 0.
HOST_SYNCS = {"n4": 0}
# Captured iterations kept (one a signature, the slots' address included:
# four levels of four shapes).
GRAPHS_KEPT = 16
_GRAPHS = collections.OrderedDict()   # signature -> _Replay, oldest use first
# By place (device index, the caller's stream): the capture stream, and
# the lock a graph-route call holds.  A place's graphs share one memory pool.
_STREAMS = {}
_LOCKS = {}
# The launch counters a captured iteration adds to at each replay.
_COUNTED = (n4_cuda.LAUNCHES, n4_sharpen_cuda.LAUNCHES)


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


def _rows(bv, power, out=None):
    """[N, ncp, P] powered rows, the kernels' layout (written into ``out``
    where given: the same values, with no [N, P, ncp] temporary)."""
    if out is None:
        return (bv ** power).transpose(1, 2).contiguous()
    return torch.pow(bv.transpose(1, 2), power, out=out)


def _masked_range(logu, wv):
    inf = torch.full_like(logu, float("inf"))
    return (torch.where(wv > 0, logu, inf).min(1).values,
            torch.where(wv > 0, logu, -inf).max(1).values)


class _Slots:
    """Where the level loop keeps what an iteration reads and writes: views
    into one allocation of the call (its ``flat`` bytes, laid out by
    ``_layout`` for the call's finest ncp), which the call frees when its
    loop ends.  A graph captured on them bakes in their address, so a
    later call whose allocation comes back there can replay it."""

    def __init__(self, dev, layout):
        self.offsets = layout[0]
        self.flat = _alloc(dev, layout[1])

    @property
    def base(self):
        return self.flat.data_ptr()

    def empty(self, name, shape, dtype=torch.float32):
        off = self.offsets[name]
        n = math.prod(shape) * dtype.itemsize
        return self.flat[off:off + n].view(dtype).view(shape)

    def zeros(self, name, shape, dtype=torch.float32):
        return self.empty(name, shape, dtype).zero_()

    def put(self, name, t):
        """A copy of ``t`` in its slot."""
        return self.empty(name, t.shape, t.dtype).copy_(t)


def _alloc(dev, nbytes):
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _layout(N, P, ncp):
    """({slot: byte offset}, bytes) of a call's slots at its finest ncp,
    each slot on a 512-byte boundary: the six basis-row tensors (each a
    prefix of its slot at coarser levels), the [N, P] vectors, the
    lattices and the per-lane state."""
    f, rows, lat = 4, N * ncp * P, N * ncp ** 3
    sizes = [(k, rows * f) for k in ("br1", "bc1", "bs1", "br3", "bc3",
                                    "bs3")]
    sizes += [(k, N * P * f) for k in ("wv", "logv", "sv", "field", "logu")]
    sizes += [("den_safe", lat * f), ("phi", lat * f), ("den_nz", lat),
              ("nmask", N * f), ("bmn", N * f), ("bmx", N * f),
              ("itc", N * 4), ("done", N)]
    offsets, end = {}, 0
    for k, n in sizes:
        offsets[k] = end
        end += -(-n // 512) * 512
    return offsets, end


def graph_pool_bytes():
    """Device bytes in the segments of the kept graphs' memory pools: the
    captured iterations' scratch, which ``torch.cuda.memory_allocated``
    (and so its peak) leaves out, and ``memory_reserved`` counts."""
    pools = {tuple(g.pool) for g in _GRAPHS.values()}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools)


def clear_graphs():
    """Drop every captured N4 iteration, once the device work queued on
    them has finished; the next call on a card captures anew."""
    for index in {key[0] for key in _GRAPHS}:
        torch.cuda.synchronize(index)
    _GRAPHS.clear()


def _graphs_engage(dev):
    """The graph route: CUDA tensors, and no capture already under way."""
    return dev.type == "cuda" and not torch.cuda.is_current_stream_capturing()


def _place(dev):
    """(device index, the caller's stream): what a graph, its capture
    stream and its memory pool belong to."""
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


@contextlib.contextmanager
def _held(place, dev):
    """The place's lock held and its device current: the graphs of a place
    are replayed by one call at a time."""
    with _LOCKS.setdefault(place, threading.Lock()):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            yield


class _Replay:
    """A captured iteration: its graph and memory pool, the launches it
    holds, and K2's ticket buffer it reads and resets, kept alive here
    because ``n4_cuda._tickets`` replaces it when a larger batch comes."""

    def __init__(self, graph, pool, launched, tickets):
        self.graph, self.pool, self.tickets = graph, pool, tickets
        self.launched = launched     # one {name: count} per _COUNTED dict

    def replay(self):
        self.graph.replay()
        for counts, add in zip(_COUNTED, self.launched):
            for k, v in add.items():
                counts[k] += v
        n4_cuda.LAUNCHES["n4_iter_graph_replays"] += 1


def _lookup(key):
    """The graph kept under ``key``, now the latest used; or None."""
    it = _GRAPHS.get(key)
    if it is not None:
        _GRAPHS.move_to_end(key)
    return it


def _remember(key, it):
    """Keep ``it`` under ``key``; past ``GRAPHS_KEPT`` the signature used
    longest ago goes."""
    _GRAPHS[key] = it
    _GRAPHS.move_to_end(key)
    while len(_GRAPHS) > GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)


def _record(place, dev, step):
    """Run ``step`` (one iteration) eagerly on the place's capture stream,
    so that everything it sets up once (K2's tickets for that stream,
    cuFFT's plans, K1's shared-memory opt-in) exists, then capture it
    there into the place's memory pool.  The capture neither empties the
    allocator's cache nor waits for the card (as ``torch.cuda.graph``
    would), so the calls after it find their slots where they were, and
    no host wait is added.
    Returns the graph, its pool, the launches the capture held (which the
    counters do not keep) and K2's tickets on the capture stream."""
    if place not in _STREAMS:
        _STREAMS[place] = torch.cuda.Stream(dev)
    # the pool lives while a graph holds it: the allocator releases a pool
    # whose graphs have all gone, and capturing into it again trips its
    # assert (use_count > 0), so such a place takes a new one
    pool = next((g.pool for k, g in _GRAPHS.items() if k[:2] == place),
                None) or torch.cuda.graph_pool_handle()
    cur, cap = torch.cuda.current_stream(dev), _STREAMS[place]
    cap.wait_stream(cur)
    with torch.cuda.stream(cap):
        step()
        tickets = n4_cuda._tickets(dev, 1)     # what the capture will read
        before = [dict(c) for c in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        with stage("n4.capture"):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
    cur.wait_stream(cap)
    launched = []
    for counts, was in zip(_COUNTED, before):
        launched.append({k: v - was[k] for k, v in counts.items()
                         if v != was[k]})
        counts.update(was)
    return graph, pool, launched, tickets


def _capture(key, dev, step):
    """A level's first iteration where no graph is kept: run eagerly, then
    captured and kept under ``key`` (its place first)."""
    it = _Replay(*_record(key[:2], dev, step))
    n4_cuda.LAUNCHES["n4_iter_graph_captures"] += 1
    _remember(key, it)
    return it


def _iterate(s, lv, bins, fwhm, wiener_noise, padded, offset, threshold):
    """One N4 iteration for every lane, in place on the level's state ``s``
    (field, logu, bmn, bmx, phi, itc, done) from its inputs ``lv``: every
    tensor it reads or writes across iterations is one of their slots, so
    a captured iteration replays on what the slots hold."""
    with stage("n4.sharpen"):
        # one slope tensor bins every voxel for K4, the table and K5
        slope = (s.bmx - s.bmn) / (bins - 1)
        hist = sharpen_hist(s.logu, lv.wv, s.bmn, slope, bins)
        e_loc = _sharpen_expectation(hist, s.bmn, slope, bins, fwhm,
                                     wiener_noise, padded, offset)
        a = sharpen_resid(s.logu, lv.wv, lv.sv, e_loc, s.bmn, slope, bins)
    with stage("n4.fit"):
        num = fit_moment(a, lv.br3, lv.bc3, lv.bs3)
        phi = torch.where(lv.den_nz, num / lv.den_safe, torch.zeros_like(num))
        field, logu, stats = fit_delta_conv_field(
            phi, lv.br1, lv.bc1, lv.bs1, lv.wv, s.field, lv.logv,
            s.done.to(torch.float32))
        s.field.copy_(field)
        s.logu.copy_(logu)
        # K4 and K5 read bmn, so it is a slot of its own, not a strided view
        s.bmn.copy_(stats[:, 2])
        s.bmx.copy_(stats[:, 3])
        s1, s2 = stats[:, 0], stats[:, 1]
        # ITK convergence: CV of exp(-delta) over the mask, from the
        # cancellation-free (e^-delta - 1) moments.
        mu = 1.0 + s1 / lv.nmask
        var = ((s2 - s1 * s1 / lv.nmask) / lv.nmask).clamp_min(0.0)
        cv = torch.sqrt(var) / mu
        torch.where(s.done[:, None, None], s.phi, s.phi + phi, out=s.phi)
        s.itc += (~s.done).to(torch.int32)
        s.done |= cv < threshold


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

    ncps = [(control_points - 3) * 2 ** level + 3
            for level in range(fitting_levels)]
    padded = _next_pow2_padded(bins)
    offset = (padded - bins) // 2
    place = _place(dev) if _graphs_engage(dev) else None
    phi_totals = []
    level_iters = []
    with _held(place, dev) if place else contextlib.nullcontext():
        slots = _Slots(dev, _layout(N, P, max(ncps)))
        wv = slots.put("wv", wv)
        vals = raw_vals.clamp_min(1.0e-30)
        logv = slots.put("logv", torch.log(
            torch.where(wv > 0, vals, torch.ones_like(vals))) * wv)
        nmask = slots.put("nmask", wv.sum(1))
        hc = idx // (W * D)
        wc = (idx // D) % W
        sc = idx % D
        field = slots.zeros("field", (N, P))
        for ncp in ncps:
            with stage("n4.level"):
                # each voxel's basis rows gathered from its axes' tables:
                # the same values, with no [N, P, ncp] temporaries of the
                # basis' arithmetic
                brv, bcv, bsv = (
                    _bspline_rows(torch.arange(n, device=dev), n,
                                  ncp - 3)[c]
                    for c, n in ((hc, H), (wc, W), (sc, D)))
                # the level's inputs and state: an iteration (and a graph
                # captured from it) reads and writes these tensors only
                lv = SimpleNamespace(wv=wv, logv=logv, nmask=nmask)
                lv.sv = slots.put("sv", (brv ** 2).sum(2) * (bcv ** 2).sum(2)
                                  * (bsv ** 2).sum(2))
                axes = (("br", brv), ("bc", bcv), ("bs", bsv))
                for name, _ in axes:
                    for k in (1, 3):
                        setattr(lv, f"{name}{k}", slots.empty(
                            f"{name}{k}", (N, ncp, P)))
                # K1's denominator from the squared rows, written where the
                # cubed rows go next (the same stream orders the two)
                den = fit_moment(wv, *(_rows(bv, 2, out=getattr(
                    lv, f"{name}3")) for name, bv in axes))
                for name, bv in axes:
                    for k in (1, 3):
                        _rows(bv, k, out=getattr(lv, f"{name}{k}"))
                lv.den_nz = slots.put("den_nz", den != 0.0)
                lv.den_safe = slots.put("den_safe", torch.where(
                    lv.den_nz, den, torch.ones_like(den)))
                del brv, bcv, bsv, axes, den

                st = SimpleNamespace(
                    field=field, phi=slots.zeros("phi", (N, ncp, ncp * ncp)),
                    done=slots.zeros("done", (N,), torch.bool),
                    itc=slots.zeros("itc", (N,), torch.int32),
                    logu=slots.put("logu", (logv - field) * wv))
                bmn, bmx = _masked_range(st.logu, wv)
                st.bmn, st.bmx = slots.put("bmn", bmn), slots.put("bmx", bmx)
                step = functools.partial(
                    _iterate, st, lv, bins, fwhm, wiener_noise, padded,
                    offset, convergence_threshold)

                key = place and place + (
                    N, P, ncp, max(ncps), bins, float(fwhm),
                    float(wiener_noise), float(convergence_threshold),
                    slots.base)
                graph = key and _lookup(key)
                for _ in range(max_iters):
                    with stage("n4.iter"):
                        if graph is not None:
                            graph.replay()
                        elif key:
                            graph = _capture(key, dev, step)
                        else:
                            step()
                        HOST_SYNCS["n4"] += 1
                        with host_wait("n4.sync"):
                            if bool(st.done.all()):
                                break
            level_iters.append(st.itc.clone())
            phi_totals.append(st.phi.clone())
        if return_compacted:
            corrected_vals = raw_vals * torch.exp(-field)
        del st, lv, step, wv, logv, nmask, field, slots

    # Dense field: every level's lattice on the full grid in one kernel
    # (ops/n4_field_cuda.py), each voxel summed in one written order, so a
    # lane's field has the same bits at any batch size.
    with stage("n4.field"):
        phi_flat = torch.cat([p.reshape(N, -1) for p in phi_totals], 1)
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
        wv_mask_only = (ar[None, :] < n_mask[:, None]).to(torch.float32)
        out = out + ((idx, corrected_vals, wv_mask_only),)
    return out if len(out) > 1 else out[0]


def n4_phi_sizes(fitting_levels: int = 4, control_points: int = 4):
    """Per-level flat lattice sizes of the return_phi vector."""
    return [((control_points - 3) * 2 ** level + 3) ** 3
            for level in range(fitting_levels)]


def n4_field_from_phi_np(
    phi_flat: np.ndarray,
    shape,
    fitting_levels: int = 4,
    control_points: int = 4,
) -> np.ndarray:
    """Host (numpy, float64) dense log-bias field from the return_phi vector.

    The float64 counterpart of the card's dense field (``n4_field``): with
    it ``hp * exp(-field)`` rebuilds the corrected volume from host inputs
    and the lattice vector (~1.9k floats at the defaults).  It is not the
    card's float32 field bit for bit (they agree to ~1e-6 relative), so the
    cohort export overwrites every masked voxel with the shipped values and
    takes this only for the out-of-mask background, which no metric reads.
    """
    H, W, D = shape
    field = np.zeros((H, W, D), np.float64)
    off = 0
    for level in range(fitting_levels):
        n_elements = (control_points - 3) * 2 ** level
        ncp = n_elements + 3
        k = ncp ** 3
        phi = np.asarray(phi_flat[off:off + k], np.float64).reshape(
            ncp, ncp, ncp)
        off += k
        br = bspline_basis_1d(H, n_elements)
        bc = bspline_basis_1d(W, n_elements)
        bs = bspline_basis_1d(D, n_elements)
        # separable: one axis at a time
        t = np.tensordot(br, phi, axes=(1, 0))      # [H, ncp, ncp]
        t = np.tensordot(bc, t, axes=(1, 1))        # [W, H, ncp]
        field += np.tensordot(t, bs, axes=(2, 1)).transpose(1, 0, 2)
    if off != len(phi_flat):
        raise ValueError(
            f"phi vector has {len(phi_flat)} coefficients; levels="
            f"{fitting_levels} control_points={control_points} expects {off}")
    return field
