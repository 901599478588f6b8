#!/usr/bin/env python3
"""Drive the PyTorch port (ventjax_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
1. device: CUDA must be available; print the card's name and power limit;
2. build: compile the CUDA kernels in ventjax_torch/csrc with nvcc, one
   nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes.  Tolerances: K1/K2 relative 1e-5 (the same
   float32 algorithm, only the summation order differs); K4 relative 1e-5
   of the largest bin (the plain version sums with float32 atomics in
   another order) and bit-identical from launch to launch; K5 bit-equal
   (the same float32 operations in the same order); K3, K9, K8 bit-equal
   (integers, and copied values);
4. paths, each with the launch counts set to 0 just before and read just
   after it:
   a. the slice: 16 phantoms of 128x128x16 through ventjax_torch.pipeline.
      analyze_cohort (N4 pad and CI pad sized as bench.py sizes them),
      launching K1, K2, K4, K5 and K3, with clean flags and finite metrics;
      a second run gives the same bits (N4, defect maps, CI map), and so
      do two N4 runs with their iteration counts; lanes 0 and 1 are held
      against the port's own CPU path;
   b. the rank-densify CI map: calculate_ci_pairwise(pallas_densify=True)
      launching K9 and K8, bit-equal to the slice's scatter map, and on
      severe-load maps (K 4096) to the scatter path;
5. timing (information only): the slice's volumes/s, the N4 and CI stages,
   each kernel beside its plain version and the densify step beside the
   scatter, with CUDA events; then one slice batch under torch.profiler:
   its device kernels, device time and busy share (the table goes to
   chiprun_out/profile_slice.txt);
6. one JSON line of kernel records, then the result line
   {"ok": true, "device": {...}} last.

It imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (128, 128, 16)
VOX = (1.5, 1.5, 10.0)
BATCH = 16
SEED = 0
BINS = 200           # N4 histogram bins (VentConfig default)
KERNEL_RTOL = 1e-5   # same f32 algorithm; only the summation order differs
LIBS = ("n4_fit", "n4_sharpen", "ci_head", "ci_densify")


def log(*args):
    print(*args, flush=True)


def scaled_err(got, want):
    """max |got - want| / max |want|, in float64."""
    got = got.double()
    want = want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps=20):
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return torch.device("cuda", 0), smi.splitlines()[0]


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ventjax_torch import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:   # one nvcc per source
        list(pool.map(_build.build, LIBS))
    for name in LIBS:
        _build.load(name)
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()}))


def headline_cohort():
    from ventjax.io.phantom import make_cohort

    hp, mask, _ = make_cohort(BATCH, SHAPE, VOX, seed=SEED)
    max_mask = int((mask > 0).sum(axis=(1, 2, 3)).max())
    n4_pad = min(int(np.prod(SHAPE)), -(-max_mask // 8192) * 8192)
    return hp, mask, n4_pad


def fit_inputs(hp, mask, n4_pad, ncp, dev):
    """The N4 fit operands of the headline cohort at one level: powered
    basis rows of the compacted masked voxels, weights, log values."""
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops.basic import sort_compact_masked

    H, W, D = SHAPE
    flat = torch.from_numpy(hp.reshape(BATCH, -1)).to(dev)
    m = torch.from_numpy(mask.reshape(BATCH, -1) > 0).to(dev)
    idx, vals, n = sort_compact_masked(flat, m, n4_pad)
    wv = ((torch.arange(n4_pad, device=dev)[None] < n[:, None])
          & (vals > 0)).float()
    logv = torch.log(torch.where(wv > 0, vals.clamp_min(1e-30),
                                 torch.ones_like(vals))) * wv
    n_el = ncp - 3
    bv = [tn4._bspline_rows(c, n, n_el)
          for c, n in ((idx // (W * D), H), ((idx // D) % W, W),
                       (idx % D, D))]
    return bv, wv, logv


def phase_kernels(hp, mask, n4_pad, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from ventjax_torch.ops import ci_cuda, n4_cuda
    from ventjax_torch.ops import n4 as tn4

    gen = np.random.default_rng(SEED)
    errs = {}
    for ncp in (4, 5, 7, 11):
        bv, wv, logv = fit_inputs(hp, mask, n4_pad, ncp, dev)
        r1 = [tn4._rows(b, 1) for b in bv]
        r2 = [tn4._rows(b, 2) for b in bv]
        r3 = [tn4._rows(b, 3) for b in bv]
        # a smooth residual, as N4 fits it
        a = (torch.sin(torch.linspace(0, 3, n4_pad, device=dev))[None]
             * wv + 0.01 * torch.from_numpy(
                 gen.normal(size=wv.shape).astype(np.float32)).to(dev) * wv)
        k1 = {}
        for tag, aa, rows in (("den", wv, r2), ("num", a, r3)):
            got = n4_cuda.fit_moment(aa, *rows)
            want = n4_cuda.fit_moment_plain(aa, *rows)
            k1[tag] = scaled_err(got, want)
            errs.setdefault("fit_moment", []).append(
                float((got - want).abs().max()))
        phi = torch.from_numpy((0.05 * (1 + 0.2 * gen.normal(
            size=(BATCH, ncp, ncp * ncp)))).astype(np.float32)).to(dev)
        field = 0.01 * torch.from_numpy(gen.normal(
            size=wv.shape).astype(np.float32)).to(dev) * wv
        done = torch.zeros(BATCH, device=dev)
        done[::3] = 1.0
        got = n4_cuda.fit_delta_conv_field(phi, *r1, wv, field, logv, done)
        want = n4_cuda.fit_delta_conv_field_plain(phi, *r1, wv, field, logv,
                                                  done)
        # s1 sums terms of both signs: hold it to the summed magnitude
        # of its terms, taken from delta of an unfrozen plain run
        nf_free = n4_cuda.fit_delta_conv_field_plain(
            phi, *r1, wv, field, logv, torch.zeros_like(done))[0]
        s_scale = (wv * torch.expm1(field - nf_free)).abs().sum(1)
        k2 = {"field": scaled_err(got[0], want[0]),
              "logu": scaled_err(got[1], want[1])}
        k2["s1"] = float(((got[2][:, 0] - want[2][:, 0]).abs()
                          / s_scale).max())
        k2["s2"] = float(((got[2][:, 1] - want[2][:, 1]).abs()
                          / want[2][:, 1].abs()).max())
        span = want[2][:, 3] - want[2][:, 2]
        k2["min"] = float(((got[2][:, 2] - want[2][:, 2]).abs() / span).max())
        k2["max"] = float(((got[2][:, 3] - want[2][:, 3]).abs() / span).max())
        frozen = bool((got[0][::3] == field[::3]).all())
        errs.setdefault("fit_delta_conv_field", []).append(
            float((got[0] - want[0]).abs().max()))
        log(f"K1 fit_moment ncp={ncp} N={BATCH} P={n4_pad}: "
            + json.dumps({k: f"{v:.2e}" for k, v in k1.items()}))
        log(f"K2 fit_delta_conv_field ncp={ncp}: "
            + json.dumps({k: f"{v:.2e}" for k, v in k2.items()})
            + f" frozen_lanes_exact={frozen}")
        bad = {k: v for k, v in {**k1, **k2}.items() if not v <= KERNEL_RTOL}
        if bad or not frozen:
            raise AssertionError(f"K1/K2 disagree with their plain versions "
                                 f"at ncp={ncp}: {bad} frozen={frozen}")

    from ventjax_torch.ops import ci_pairwise as tcp

    geom = tcp.build_ci_pairwise_geometry(VOX, SHAPE, 50, "wrap")
    ns = min(96, geom.n_balls - 1)
    r2 = torch.as_tensor(geom.r2_32[:ns], device=dev)
    combos = tcp._alias_combos(geom)
    for K in (1024, 4096):
        coords = severe_coords(K, gen, dev)
        got = ci_cuda.head_counts(coords, coords, r2, combos, geom.scale,
                                  geom.rmax)
        want = ci_cuda.head_counts_plain(coords, coords, r2, combos,
                                         geom.scale, geom.rmax)
        equal = bool(torch.equal(got, want))
        log(f"K3 head_counts K={K} N={BATCH} ns={ns} wrap: "
            f"bit_equal={equal} max_count={int(want.max())}")
        if not equal:
            raise AssertionError(f"K3 counts differ from the plain version "
                                 f"at K={K}")
    errs["head_counts"] = [0.0]
    errs.update(check_sharpen(hp, mask, n4_pad, dev))
    errs.update(check_densify(gen, dev))
    return {k: max(v) for k, v in errs.items()}


def sharpen_inputs(hp, mask, n4_pad, dev):
    """N4's first sharpen operands on the headline cohort: the log values,
    weights, finest-level normaliser sv, range and slope."""
    from ventjax_torch.ops import n4 as tn4

    bv, wv, logv = fit_inputs(hp, mask, n4_pad, 11, dev)
    sv = (bv[0] ** 2).sum(2) * (bv[1] ** 2).sum(2) * (bv[2] ** 2).sum(2)
    bmn, bmx = tn4._masked_range(logv, wv)
    return logv, wv, sv, bmn, (bmx - bmn) / (BINS - 1)


def expectation(hist, bmn, slope):
    from ventjax.config import DEFAULT_CONFIG as c
    from ventjax_torch.ops import n4 as tn4

    padded = tn4._next_pow2_padded(BINS)
    return tn4._sharpen_expectation(hist, bmn, slope, BINS, c.n4_bias_fwhm,
                                    c.n4_wiener_noise, padded,
                                    (padded - BINS) // 2)


def check_sharpen(hp, mask, n4_pad, dev):
    """K4 and K5 against their plain versions at the slice's shapes."""
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    logu, wv, sv, bmn, slope = sharpen_inputs(hp, mask, n4_pad, dev)
    got = sc.sharpen_hist(logu, wv, bmn, slope, BINS)
    again = sc.sharpen_hist(logu, wv, bmn, slope, BINS)
    want = sc.sharpen_hist_plain(logu, wv, bmn, slope, BINS)
    k4 = scaled_err(got, want)
    same = bool(torch.equal(got, again))
    log(f"K4 sharpen_hist N={BATCH} P={n4_pad} bins={BINS}: rel {k4:.2e} "
        f"relaunch_bit_identical={same} mass_err "
        f"{float((got.double().sum(1) - wv.double().sum(1)).abs().max()):.2e}")
    if not (k4 <= KERNEL_RTOL and same):
        raise AssertionError(f"K4 disagrees with its plain version ({k4}) "
                             f"or is not deterministic ({same})")
    e_loc = expectation(got, bmn, slope)
    a = sc.sharpen_resid(logu, wv, sv, e_loc, bmn, slope, BINS)
    a_plain = sc.sharpen_resid_plain(logu, wv, sv, e_loc, bmn, slope, BINS)
    k5 = float((a - a_plain).abs().max())
    log(f"K5 sharpen_resid: bit_equal={bool(torch.equal(a, a_plain))} "
        f"max_abs {k5:.2e} finite={bool(torch.isfinite(a).all())}")
    if not torch.equal(a, a_plain):
        raise AssertionError(f"K5 differs from its plain version: {k5}")
    return {"sharpen_hist": [float((got - want).abs().max())],
            "sharpen_resid": [k5]}


def check_densify(gen, dev):
    """K9 and K8 bit-equal to their plain versions on severe-load maps
    (V 262,144 at K 512 and 4096, and a ragged V)."""
    from ventjax_torch.ops import ci_densify_cuda as cd

    V = int(np.prod(SHAPE))
    for K in (512, 4096):
        d01 = torch.from_numpy(severe_defects(K, gen).reshape(BATCH, V)
                               > 0).to(dev)
        cv = torch.from_numpy(gen.random((BATCH, K)).astype(
            np.float32)).to(dev)
        for tag, d in (("V", d01), ("ragged V", d01[:, :V - 1234])):
            d = d.contiguous()
            r = cd.rank(d)
            eq9 = bool(torch.equal(r, cd.rank_plain(d)))
            eq8 = bool(torch.equal(cd.densify_rank(r, d, cv, K),
                                   cd.densify_rank_plain(r, d, cv, K)))
            log(f"K9 rank / K8 densify_rank K={K} {tag}={d.shape[1]}: "
                f"bit_equal={eq9}/{eq8} defects/lane "
                f"{int(d.sum(1).min())}-{int(d.sum(1).max())}")
            if not (eq9 and eq8):
                raise AssertionError(f"K9/K8 differ from their plain "
                                     f"versions at K={K}, {tag}")
    return {"rank": [0.0], "densify_rank": [0.0]}


def severe_defects(K, gen):
    """[BATCH, H, W, D] defect maps of severe disease: clustered blobs
    until each lane holds ~3/4 of K defect voxels."""
    H, W, D = SHAPE
    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                             indexing="ij")
    out = np.zeros((BATCH,) + SHAPE, np.float32)
    for n in range(BATCH):
        while out[n].sum() < 0.75 * K:
            c = gen.uniform([20, 20, 0], [H - 20, W - 20, D])
            r = gen.uniform([3, 3, 1], [10, 10, 3])
            blob = (((ii - c[0]) / r[0]) ** 2 + ((jj - c[1]) / r[1]) ** 2
                    + ((kk - c[2]) / r[2]) ** 2) <= 1.0
            out[n][blob & (gen.random(SHAPE) < 0.8)] = 1.0
    return out


def severe_coords(K, gen, dev):
    """Defect coordinates, as calculate_ci_pairwise builds them, of a
    severe-load batch."""
    from ventjax_torch.ops.ci_pairwise import defect_coords

    return defect_coords(torch.from_numpy(severe_defects(K, gen)).to(dev),
                         K)[0]


def counters():
    from ventjax_torch.ops import (ci_cuda, ci_densify_cuda, n4, n4_cuda,
                                   n4_sharpen_cuda)

    return (n4_cuda.LAUNCHES, n4_sharpen_cuda.LAUNCHES, ci_cuda.LAUNCHES,
            ci_densify_cuda.LAUNCHES, n4.HOST_SYNCS)


def reset_counts():
    for d in counters():
        for k in d:
            d[k] = 0


def launch_counts():
    return {k: v for d in counters()[:-1] for k, v in d.items()}


def phase_slice(hp, mask, n4_pad, dev):
    from ventjax.config import DEFAULT_CONFIG
    from ventjax_torch.ops import n4
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    hp_d = torch.from_numpy(hp).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    # sizing pass (as bench.py): a roomy CI pad, then the power-of-two
    # bucket that covers the largest defect count
    cfg0 = DEFAULT_CONFIG.replace(ci_max_defect_voxels=8192,
                                  n4_mask_pad=n4_pad)
    t0 = time.perf_counter()
    res0 = analyze_cohort(hp_d, mask_d, build_geometry(VOX, SHAPE, cfg0), cfg0)
    if bool(res0.metrics.ci_overflow.any()):
        raise AssertionError("sizing pass overflowed the CI pad")
    n_def = int(res0.defect.reshape(BATCH, -1).sum(1).max())
    K = max(256, 1 << int(np.ceil(np.log2(max(n_def, 1)))))
    log(f"sizing pass: {time.perf_counter() - t0:.1f} s, n4_mask_pad={n4_pad}"
        f", max defect voxels {n_def} -> ci_max_defect_voxels={K}")
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=K, n4_mask_pad=n4_pad)
    geom = build_geometry(VOX, SHAPE, cfg)

    torch.cuda.synchronize()
    reset_counts()
    res = analyze_cohort(hp_d, mask_d, geom, cfg)
    torch.cuda.synchronize()
    launches = launch_counts()
    syncs = n4.HOST_SYNCS["n4"]
    log(f"slice launches: {json.dumps(launches)}; N4 host syncs: {syncs}")
    path = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
            "sharpen_resid", "head_counts")
    if not all(launches[k] > 0 for k in path):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    check_repeat(hp_d, mask_d, geom, cfg, res, syncs)

    mt = res.metrics
    flags = {"ci_overflow": bool(mt.ci_overflow.any()),
             "n4_overflow": bool(mt.n4_overflow.any()),
             "all_valid": bool(mt.valid.all())}
    finite = all(bool(torch.isfinite(getattr(mt, f)).all())
                 for f in ("snr", "vdp", "vdp_lb", "vdp_km", "lung_volume",
                           "defect_volume", "ci"))
    log(f"slice flags: {json.dumps(flags)} metrics_finite={finite}")
    for name in ("snr", "vdp", "vdp_lb", "vdp_km", "ci", "ci_saturated"):
        log(f"  {name}: {[round(float(v), 4) for v in getattr(mt, name)]}")
    if flags["ci_overflow"] or flags["n4_overflow"] or not flags["all_valid"] \
            or not finite:
        raise AssertionError("the slice did not run clean")
    expect_shape = (BATCH,) + SHAPE
    for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"):
        if tuple(getattr(res, f).shape) != expect_shape:
            raise AssertionError(f"{f} has shape {getattr(res, f).shape}")

    # lanes 0 and 1 against the port's own CPU path
    t0 = time.perf_counter()
    cpu = analyze_cohort(torch.from_numpy(hp[:2]), torch.from_numpy(mask[:2]),
                         geom, cfg)
    log(f"CPU path, lanes 0-1: {time.perf_counter() - t0:.1f} s")
    for i in range(2):
        dv = {n: abs(float(getattr(mt, n)[i]) - float(getattr(cpu.metrics,
                                                               n)[i]))
              for n in ("vdp", "vdp_lb", "vdp_km")}
        same_defect = torch.equal(res.defect[i].cpu(), cpu.defect[i])
        same_ci = torch.equal(res.ci_map[i].cpu(), cpu.ci_map[i])
        log(f"  lane {i}: |dVDP| pp {json.dumps(dv)} "
            f"defect_equal={same_defect} ci_map_equal={same_ci}")
        if max(dv.values()) >= 0.1:
            raise AssertionError(f"lane {i}: GPU and CPU VDPs differ: {dv}")
        if same_defect and not same_ci:
            raise AssertionError(f"lane {i}: same defects, different CI map")
    return cfg, geom, hp_d, mask_d, res, launches, syncs


def n4_call(hp_d, mask_d, cfg, **kw):
    """N4 on the batch with the pipeline's parameters."""
    from ventjax_torch.ops.n4 import n4_bias_correction

    return n4_bias_correction(
        hp_d, mask_d, fitting_levels=cfg.n4_fitting_levels,
        max_iters=cfg.n4_max_iters,
        convergence_threshold=cfg.n4_convergence_threshold,
        bins=cfg.n4_histogram_bins, fwhm=cfg.n4_bias_fwhm,
        wiener_noise=cfg.n4_wiener_noise,
        control_points=cfg.n4_control_points, mask_pad=cfg.n4_mask_pad, **kw)


def check_repeat(hp_d, mask_d, geom, cfg, res, syncs):
    """Determinism: a second slice run, and two N4 runs with their
    per-lane iteration counts, give the same bits."""
    from ventjax_torch.ops import n4
    from ventjax_torch.pipeline import analyze_cohort

    n4.HOST_SYNCS["n4"] = 0
    res2 = analyze_cohort(hp_d, mask_d, geom, cfg)
    same = {f: bool(torch.equal(getattr(res, f), getattr(res2, f)))
            for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map")}
    same["n4_host_syncs"] = n4.HOST_SYNCS["n4"] == syncs
    (a, ia), (b, ib) = (n4_call(hp_d, mask_d, cfg, return_iters=True)
                        for _ in range(2))
    same["n4_alone"] = bool(torch.equal(a, b))
    same["n4_iters"] = bool(torch.equal(ia, ib))
    log(f"repeat runs bit-identical: {json.dumps(same)}; N4 iterations per "
        f"level (lane 0): {ia[0].tolist()}, total per lane "
        f"{ia.sum(1).tolist()}")
    if not all(same.values()):
        raise AssertionError(f"two runs on the card differ: {same}")


def phase_densify(res, geom, cfg, dev):
    """The rank-densify CI map (K9, K8) against the scatter map, on the
    slice's defects and on severe-load maps at K 4096."""
    from ventjax_torch.ops import ci_pairwise as tcp

    K = cfg.ci_max_defect_voxels
    torch.cuda.synchronize()
    reset_counts()
    ci = tcp.calculate_ci_pairwise(res.defect, geom, K, tail_k=cfg.ci_tail_k,
                                   pallas_densify=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"densify path launches: {json.dumps(launches)}")
    if not (launches["rank"] > 0 and launches["densify_rank"] > 0):
        raise AssertionError(f"K9/K8 never launched: {launches}")
    mt = res.metrics
    equal = (torch.equal(ci[0], res.ci_map)
             and torch.equal(ci[1], mt.ci_saturated)
             and torch.equal(ci[2], mt.ci_overflow))
    log(f"densify CI map == slice scatter map (K {K}): {equal}")
    gen = np.random.default_rng(SEED + 1)
    severe = torch.from_numpy(severe_defects(4096, gen)).to(dev)
    dens = tcp.calculate_ci_pairwise(severe, geom, 4096, pallas_densify=True)
    scat = tcp.calculate_ci_pairwise(severe, geom, 4096)
    equal_severe = all(torch.equal(x, y) for x, y in zip(dens, scat))
    log(f"densify == scatter on severe-load maps (K 4096): {equal_severe}; "
        f"overflow {dens[2].tolist()}")
    if not (equal and equal_severe):
        raise AssertionError("the rank-densify CI map differs from the "
                             "scatter map")
    return {k: launches[k] for k in ("rank", "densify_rank")}


def host_ms(fn, reps=5):
    """Median milliseconds of reps synchronised calls, by the host clock."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad, dev):
    """Slice vol/s (median of 5 synchronised runs), the N4 and CI stages,
    and each kernel's time beside its plain version's, at the main path's
    shapes."""
    from ventjax_torch.ops import ci_cuda
    from ventjax_torch.ops import ci_densify_cuda as cd
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops import n4_cuda
    from ventjax_torch.ops import n4_sharpen_cuda as sc
    from ventjax_torch.pipeline import analyze_cohort

    med, times = host_ms(lambda: analyze_cohort(hp_d, mask_d, geom, cfg))
    log(f"slice: median {med:.1f} ms per batch of {BATCH} -> "
        f"{BATCH * 1e3 / med:.2f} vol/s  (runs ms: "
        f"{[round(t, 1) for t in times]})")
    K = cfg.ci_max_defect_voxels
    stages = {
        "n4": host_ms(lambda: n4_call(hp_d, mask_d, cfg), reps=3)[0],
        "ci_scatter": host_ms(lambda: tcp.calculate_ci_pairwise(
            res.defect, geom, K, tail_k=cfg.ci_tail_k))[0],
        "ci_densify": host_ms(lambda: tcp.calculate_ci_pairwise(
            res.defect, geom, K, tail_k=cfg.ci_tail_k,
            pallas_densify=True))[0],
    }
    log("stages, median ms (host clock, synchronised): "
        + json.dumps({k: round(v, 2) for k, v in stages.items()}))

    bv, wv, logv = fit_inputs(hp, mask, n4_pad, 11, dev)
    r1 = [tn4._rows(b, 1) for b in bv]
    r3 = [tn4._rows(b, 3) for b in bv]
    a = wv * 0.1
    phi = torch.full((BATCH, 11, 121), 0.05, device=dev)
    done = torch.zeros(BATCH, device=dev)
    ms = {
        "fit_moment": (cuda_ms(lambda: n4_cuda.fit_moment(a, *r3)),
                       cuda_ms(lambda: n4_cuda.fit_moment_plain(a, *r3))),
        "fit_delta_conv_field": (
            cuda_ms(lambda: n4_cuda.fit_delta_conv_field(
                phi, *r1, wv, wv, logv, done)),
            cuda_ms(lambda: n4_cuda.fit_delta_conv_field_plain(
                phi, *r1, wv, wv, logv, done))),
    }
    logu, wv, sv, bmn, slope = sharpen_inputs(hp, mask, n4_pad, dev)
    e_loc = expectation(sc.sharpen_hist(logu, wv, bmn, slope, BINS), bmn,
                        slope)
    ms["sharpen_hist"] = tuple(cuda_ms(lambda f=f: f(
        logu, wv, bmn, slope, BINS)) for f in (sc.sharpen_hist,
                                               sc.sharpen_hist_plain))
    ms["sharpen_resid"] = tuple(cuda_ms(lambda f=f: f(
        logu, wv, sv, e_loc, bmn, slope, BINS)) for f in (
            sc.sharpen_resid, sc.sharpen_resid_plain))
    coords, cidx, _, valid = tcp.defect_coords(res.defect, K)
    ns = min(96, geom.n_balls - 1)
    r2 = torch.as_tensor(geom.r2_32[:ns], device=dev)
    combos = tcp._alias_combos(geom)
    ms["head_counts"] = (
        cuda_ms(lambda: ci_cuda.head_counts(coords, coords, r2, combos,
                                            geom.scale, geom.rmax)),
        cuda_ms(lambda: ci_cuda.head_counts_plain(coords, coords, r2, combos,
                                                  geom.scale, geom.rmax),
                reps=5))
    V = int(np.prod(SHAPE))
    d01 = (res.defect != 0).reshape(BATCH, V)
    rank = cd.rank(d01)
    cv = torch.rand((BATCH, K), device=dev)
    ms["rank"] = (cuda_ms(lambda: cd.rank(d01)),
                  cuda_ms(lambda: cd.rank_plain(d01)))
    ms["densify_rank"] = (
        cuda_ms(lambda: cd.densify_rank(rank, d01, cv, K)),
        cuda_ms(lambda: cd.densify_rank_plain(rank, d01, cv, K)))
    for k, (kern, plain) in ms.items():
        log(f"time {k}: kernel {kern:.4f} ms, plain {plain:.4f} ms")

    def scatter():
        flat = torch.zeros((BATCH, V + 1), device=dev)
        flat.scatter_(1, torch.where(valid, cidx, torch.full_like(cidx, V)),
                      cv)
        return flat[:, :V].reshape(res.defect.shape)

    dense_ms = (cuda_ms(lambda: cd.densify_rank(cd.rank(d01), d01, cv, K)),
                cuda_ms(scatter))
    log(f"time dense CI map (K {K}): rank+densify {dense_ms[0]:.4f} ms, "
        f"scatter {dense_ms[1]:.4f} ms")
    return med, ms


def phase_profile(cfg, geom, hp_d, mask_d):
    """One slice batch under torch.profiler: device time by kernel and the
    device's busy share of the traced span, to chiprun_out/."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from ventjax_torch.pipeline import analyze_cohort

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        analyze_cohort(hp_d, mask_d, geom, cfg)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events)) if events else 0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_slice.txt").write_text(table)
    log(f"profile: {len(events)} device kernels, {busy_us / 1e3:.2f} ms "
        f"device time in a {span_us / 1e3:.2f} ms span (busy share "
        f"{busy_us / max(span_us, 1):.3f}); table in "
        f"chiprun_out/profile_slice.txt")


def main():
    dev, card = phase_device()
    phase_build()
    hp, mask, n4_pad = headline_cohort()
    max_err = phase_kernels(hp, mask, n4_pad, dev)
    cfg, geom, hp_d, mask_d, res, launches, syncs = phase_slice(
        hp, mask, n4_pad, dev)
    launches.update(phase_densify(res, geom, cfg, dev))
    med, ms = phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad,
                           dev)
    phase_profile(cfg, geom, hp_d, mask_d)
    log(f"summary: card={card!r} slice_vol_per_s={BATCH * 1e3 / med:.3f} "
        f"n4_host_syncs={syncs} ci_max_defect_voxels="
        f"{cfg.ci_max_defect_voxels} n4_mask_pad={n4_pad}")
    src = {
        "fit_moment": ("ventjax_torch/csrc/n4_fit.cu",
                       "ventjax/ops/n4_pallas.py:106"),
        "fit_delta_conv_field": ("ventjax_torch/csrc/n4_fit.cu",
                                 "ventjax/ops/n4_pallas.py:422"),
        "sharpen_hist": ("ventjax_torch/csrc/n4_sharpen.cu",
                         "ventjax/ops/n4_pallas.py:249"),
        "sharpen_resid": ("ventjax_torch/csrc/n4_sharpen.cu",
                          "ventjax/ops/n4_pallas.py:315"),
        "head_counts": ("ventjax_torch/csrc/ci_head.cu",
                        "ventjax/ops/ci_pallas.py:116"),
        "rank": ("ventjax_torch/csrc/ci_densify.cu",
                 "ventjax/ops/ci_pallas.py:305"),
        "densify_rank": ("ventjax_torch/csrc/ci_densify.cu",
                         "ventjax/ops/ci_pallas.py:233"),
    }
    kernels = [{"name": k, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[k], "max_abs_err": max_err[k],
                "ms": ms[k][0], "plain_ms": ms[k][1]}
               for k, (s, r) in src.items()]
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    if jax_mods:
        raise AssertionError(f"the port loaded JAX: {jax_mods[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
