#!/usr/bin/env python3
"""Drive the PyTorch port (ventjax_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
1. device: CUDA must be available; print the card's name and power limit;
2. build: compile the CUDA kernels in ventjax_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K1/K2 relative 1e-5: the same float32 algorithm,
   only the summation order differs; K3 bit-equal: integer counts);
4. slice: 16 phantoms of 128x128x16 through ventjax_torch.pipeline.
   analyze_cohort on the card (N4 pad and CI pad sized as bench.py sizes
   them), with every kernel's launch count > 0, clean flags and finite
   metrics; lanes 0 and 1 are held against the port's own CPU path;
5. timing (information only): the slice's volumes/s and each kernel beside
   its plain version, with CUDA events;
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
KERNEL_RTOL = 1e-5   # same f32 algorithm; only the summation order differs


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
    from ventjax_torch import _build

    t0 = time.perf_counter()
    for name in ("n4_fit", "ci_head"):
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
    return {k: max(v) for k, v in errs.items()}


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


def reset_counts():
    from ventjax_torch.ops import ci_cuda, n4, n4_cuda

    for d in (n4_cuda.LAUNCHES, ci_cuda.LAUNCHES, n4.HOST_SYNCS):
        for k in d:
            d[k] = 0


def phase_slice(hp, mask, n4_pad, dev):
    from ventjax.config import DEFAULT_CONFIG
    from ventjax_torch.ops import ci_cuda, n4, n4_cuda
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
    launches = {**n4_cuda.LAUNCHES, **ci_cuda.LAUNCHES}
    syncs = n4.HOST_SYNCS["n4"]
    log(f"main path launches: {json.dumps(launches)}; N4 host syncs: {syncs}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

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


def phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad, dev):
    """Slice vol/s (median of 5 synchronised runs) and each kernel's time
    beside its plain version's, at the main path's shapes."""
    from ventjax_torch.ops import ci_cuda, n4_cuda
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.pipeline import analyze_cohort

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        analyze_cohort(hp_d, mask_d, geom, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"slice: median {med * 1e3:.1f} ms per batch of {BATCH} -> "
        f"{BATCH / med:.2f} vol/s  (runs ms: "
        f"{[round(t * 1e3, 1) for t in times]})")

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
    coords = tcp.defect_coords(res.defect, cfg.ci_max_defect_voxels)[0]
    ns = min(96, geom.n_balls - 1)
    r2 = torch.as_tensor(geom.r2_32[:ns], device=dev)
    combos = tcp._alias_combos(geom)
    ms["head_counts"] = (
        cuda_ms(lambda: ci_cuda.head_counts(coords, coords, r2, combos,
                                            geom.scale, geom.rmax)),
        cuda_ms(lambda: ci_cuda.head_counts_plain(coords, coords, r2, combos,
                                                  geom.scale, geom.rmax),
                reps=5))
    for k, (kern, plain) in ms.items():
        log(f"time {k}: kernel {kern:.4f} ms, plain {plain:.4f} ms")
    return med, ms


def main():
    dev, card = phase_device()
    phase_build()
    hp, mask, n4_pad = headline_cohort()
    max_err = phase_kernels(hp, mask, n4_pad, dev)
    cfg, geom, hp_d, mask_d, res, launches, syncs = phase_slice(
        hp, mask, n4_pad, dev)
    med, ms = phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad,
                           dev)
    log(f"summary: card={card!r} slice_vol_per_s={BATCH / med:.3f} "
        f"n4_host_syncs={syncs} ci_max_defect_voxels="
        f"{cfg.ci_max_defect_voxels} n4_mask_pad={n4_pad}")
    src = {
        "fit_moment": ("ventjax_torch/csrc/n4_fit.cu",
                       "ventjax/ops/n4_pallas.py:106"),
        "fit_delta_conv_field": ("ventjax_torch/csrc/n4_fit.cu",
                                 "ventjax/ops/n4_pallas.py:422"),
        "head_counts": ("ventjax_torch/csrc/ci_head.cu",
                        "ventjax/ops/ci_pallas.py:116"),
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
