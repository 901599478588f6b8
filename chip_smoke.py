#!/usr/bin/env python3
"""Drive the PyTorch port (ventjax_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--parent DIR]

Phases, in order; any failure raises and the script exits non-zero:
1. device: CUDA must be available; print the card's name and power limit;
2. build: compile the CUDA kernels in ventjax_torch/csrc with nvcc, one
   nvcc per source (five libraries), all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes.  Tolerances: K1/K2/K6/K7 relative 1e-5 (the same
   float32 algorithm, only the summation order differs), K1 at every ncp N4
   runs (4, 5, 7, 11) for the denominator and the numerator and
   bit-identical on relaunch, and K7 bit-equal to the flushed, weighted K6
   and to K2 with done = 0 (shared code); K4, on the first iteration's
   residual and on a late one (LATE_ITERS iterations of level 0 run here),
   relative 1e-5 of the largest bin against its plain version summed in
   float64, bit-equal to its exact fixed-point plain version and from
   launch to launch; K5 bit-equal (the same float32 operations in the same order);
   K3 (on severe-load maps at K 1024, 2048, 4096, and at the adult
   cell's K = Kw = 32,768 on two lanes of 256x256x16), K10 (on the CI
   engine's tails of severe-load maps at the three benchmark cells' tail
   shapes, the adult's on two lanes, against its plain version, the sort
   path), K9, K8 bit-equal
   (integers, and copied values), K9 also at ragged V (4,112, 100,003), on
   rows whose flags lie only in their last tile, and on a relaunch right
   after a call of another shape (its workspace is left zero); N4's
   dense-field kernel (n4_field, port-only: ventjax has an einsum there) on
   N4's lattices of the headline batch (N 16, 128x128x16, ncp 4, 5, 7,
   11) bit-equal to its plain version and on relaunch, and each lane's
   field bit-identical in batches of 1, 2, 4, 8 and 16;
4. paths, each with the launch counts set to 0 just before and read just
   after it:
   a. the slice: 16 phantoms of 128x128x16 through ventjax_torch.pipeline.
      analyze_cohort (N4 pad and CI pad sized as bench.py sizes them),
      launching K1, K2, K4, K5, K3, K10 and the dense-field kernel, with
      clean flags and finite metrics;
      a second run gives the same bits (N4, defect maps, CI map), and so
      do two N4 runs with their iteration counts; lanes 0 and 1 are held
      against the port's own CPU path;
   b. the rank-densify CI map: calculate_ci_pairwise(pallas_densify=True)
      launching K9 and K8, bit-equal to the slice's scatter map, and on
      severe-load maps (K 4096) to the scatter path;
   c. the unfused B-spline fit chain (the counterpart of
      benchmarks/n4_pallas_micro.py) on the slice's compacted voxels at
      N4 level 3: K1 for the denominator, then 20 iterations of K1, the
      coefficients and K6, and one K7 on the last coefficients, held
      against the same chain through the plain versions (relative 1e-5);
   d. the gather-ladder CI engine: analyze_cohort with ci_engine="ladder"
      on the slice, its CI map bit-equal to the pairwise one (both are
      exact), no stage overflow; the witness geometry that fails the
      pairwise proof gets the ladder;
   e. the cohort driver: run_cohort(device=card) on 32 synthetic DICOM
      studies of 128x128x16 (two batches of 16; one severe study that
      overflows the first CI pad and is retried) and one entry that does
      not decode; every export written, metrics of the first 16 within
      0.1 pp of analyze_cohort on the same volumes, and a second run
      resumes every subject without a kernel launch; the run takes the
      compact export pack (the default), and a run with the dense pack
      (compact_export=False, cohort --dense-export) writes the same
      metrics, defect and CI channels and masked N4 voxels, the N4
      background within 1e-5 relative;
   f. the watch-folder service: WatchService(device=card) prewarmed for
      the geometry, then an inbox of 16 back-dated studies of 128x128x16
      analysed in one batch by the first scan (K1-K5 launched; each
      study's VDPs within 0.1 pp of analyze_cohort on the same volumes), a
      second scan with nothing new and no kernel launch, a fresh arrival
      held pending until back-dated and then analysed by the warm runner,
      a corrupt study that fails alone, waits in awaiting_retry and is
      retried, and serve_forever with the scan watchdog armed (its exit
      seam stubbed, never fired);
   g. the reference's class on the card: Vent_Analysis (no device
      argument: the card is its default) on a written study of 128x128x16
      and a severe one whose CI pad reaches K >= 2048, calculate_VDP and
      calculate_CI (K1, K2, K4, K5 launched, and K3 for each study), a
      second calculate_VDP bit-identical, editMask on the card equal to
      the CPU, every export read back with the port's codecs (NIfTI
      channel 4, overlay DICOMs plain and RLE pure red exactly at the
      defects, NPZ and pickle restoring the metrics), process_RAW of a
      128x128x16 TWIX file within 1e-5 of numpy's recon, and the twix,
      analyze and export --recalculate commands (where Pillow is absent,
      analyze must stop with exit 2 naming it); then, outside the counted
      run, for each study: K1 and K2 at every ncp and K4 and K5 on a first
      and a late residual against their plain versions on its N4 operands
      (N 1, P its lung's pad; tolerances as in phase 3), K3 bit-equal
      to its plain version on its defect coordinates at its CI pad
      (ci_module.defect_pad; whether the first pairwise call overflowed,
      so that the facade retried at tail_k = pad, is logged), and its
      defect arrays (mean-anchored, LB, KM) and CI map equal to
      analyze_study's on the same arrays, its VDPs within 0.1 pp;
   h. the segmentation model: the shipped checkpoint
      (ventjax_torch/models/seg_ckpt.npz) loaded on the card equal to its
      CPU load; predict_mask on the 24 held-out make_random_phantom seeds
      10,000-10,023 (random shapes): every Dice >= 0.9 and the mean >=
      0.93, each card mask equal to the port's CPU mask except where the
      CPU |logit| < 1e-3 (counted and logged), a second prediction
      bit-identical; out-of-family Dice on 24 make_oof_phantom seeds
      logged; mask_qc passing a healthy prediction and flagging the
      prediction on a pure-noise proton and four bad masks; the analyze
      --auto-mask command on a written make_phantom(seed=77) study (the
      counted run: K1, K2, K4, K5 and K3 launched) within 2.0 pp VDP and
      12 % lung volume of the hand-mask run, reporting automask_suspect;
      train-seg --steps 5 and analyze --auto-mask on its checkpoint (exit
      0, or exit 2 naming an empty mask: five steps from flax's init may
      predict no lung); 20
      train steps at train-seg's defaults (base 16, 8 x 16 slices of 128 x
      128, lr 1e-3, seed 0) with a finite, falling loss; one step on the
      card and on the CPU on the same batch from flax's init (seed 0) and
      from the shipped parameters: the losses within 1e-5 relative, the
      gradients within 1e-4 of max |g|, and from the init the parameters
      within 1e-5 absolute (from the converged checkpoint Adam's first step
      magnifies gradient differences near its eps: logged);
   i. dist/ on the card, with the device list of dist.mesh replaced by four
      shards of the one card; its references (the unsharded maps, the
      cohort without the mesh, the plain analyze command) run first,
      outside the counts, and each of its entries below runs in its own
      window, the counts set to 0 just before it and read just after, with
      K3 required in every entry, once a shard where the entry runs the CI
      once, and K1, K2, K4, K5 in every entry that runs N4:
      calculate_ci_sharded on benchmarks/run.py
      config 7's oversize volume (256x256x64, make_severe_defects, rmax 50,
      K 4096 a shard) over 4 shards, K3 launched once on each, bit-equal
      to the unsharded calculate_ci_pairwise with no overflow; path g's
      severe study through Vent_Analysis with ci_shard_slices 2 and
      calculate_ci_sharded at 2 shards, both equal to the exact unsharded
      map; the slice through shard_cohort_fn on 4 shards, every output
      field bit-identical to path a's batch of 16 (the differing fields
      and their largest deviation are logged); run_cohort with use_mesh on
      path e's 32 studies, every export byte-equal to a run without the
      mesh; analyze --shard-slices 2 printing the unsharded command's
      metrics; then, outside the counted run, two ranks of this script
      (--rank) under gloo on the one card and one rank per card under
      NCCL, each rank's slab of the oversize map bit-equal; K3 on each
      shard's own (centers, local + halo witnesses), Kw = 2K on an
      interior shard, bit-equal to its plain version;
   j. the multi-process cohort driver: two ranks of this script (--rank
      with a job) under gloo sharing the card, each running run_cohort
      with use_mesh over a RankMesh on path e's 32 studies, with process-0
      export and with shard_export, each mode in its own counted window
      in every rank (K1, K2, K4, K5, K3 and the dense-field kernel
      required on both ranks), then a second call that resumes everything
      without a launch; then one NCCL rank per card with process-0 export;
      every export byte-equal to path e's one-process run of the same
      studies (metrics.json but for the export_process stamp of
      shard_export, whose files must come from both ranks); one-lane
      shards arise there (the partial batch, the severe study's retry);
   k. the GUI controller headless on the card: VentController (no device
      argument) over path g's typical study, load, calculate VDP,
      calculate CI and export in one counted window (K1, K2, K4, K5, K3 and
      the dense-field kernel required), the statuses, colours and button
      states of tests/test_gui.py (the export orange: exported, no archive
      path), the in-progress blue statuses, VDPs within 0.1 pp of
      Vent_Analysis on the same study and its CI map equal, and the
      export's files;
   l. the space axis (dist.make_batch_space_mesh, dist.spatial_shard_fn,
      models.segmentation.make_sharded_train_step), each run in its own
      counted window: the headline batch over a 4 x 4 mesh of the card
      (32 rows a slab) against path a's analyze_cohort of the same batch
      (defect maps and CI map equal, SNR and the flags bit-equal, VDPs
      within 0.1 pp and equal where N4's image is, its deviation printed),
      a repeat bit-identical, batch row 0's N4 iteration counts over its
      slabs equal on a repeat and to the unsharded N4's; path i's
      256x256x64 geometry as one study (make_cohort, seed 0, N4 pad
      covering its mask) over a 1 x 4 mesh, the same checks, with the peak
      memory above the start beside the unsharded run's (one shard a card
      where four cards are visible); K1 (its partial), K2, K4 (its
      partial), K5 and the dense field at least once a slab and K3 once a
      batch row in each window; outside them, each kernel on its slab
      operands against its plain version, and K1's reduce, K2's fold and
      K4's finish against their plain versions and the one-call entry
      points; then the train step at base 16 on path h's training shapes
      over a 2 x 4 mesh, 3 steps from train_step's state (loss within
      1e-5 relative, parameters within SEG_STEP_ATOL), host ms and device
      ms of each run beside the unsharded run's;
   m. the space axis over torch.distributed ranks, one slab a rank
      (dist.make_rank_space_mesh; ranks of this script, --rank with a
      space job): four gloo ranks sharing the card run the headline batch
      over a (2, 2) rank mesh, path l's 256x256x64 study over (1, 4) and
      the train step at base 16 on path h's shapes over (2, 2), 3 steps;
      then one NCCL rank runs the headline over (1, 1).  Each analysis
      run in each rank's own counted window, every rank's gathered result
      bit-equal to the unsharded analyze_cohort's (path a's for the
      headline) and the same on every rank, a repeat bit-identical, the
      headline's N4 iteration counts over each row's slabs equal to the
      unsharded N4's, K1 (its partial), K2, K4 (its partial), K5 and the
      dense field launched in every rank's window and K3 in each batch
      row's first rank's (the row's CI engine runs there), each kernel on
      that rank's operands held to its plain version; each rank's peak
      memory above its start logged; the train step's losses within 1e-6
      relative of train_step's and its parameters bit-identical across
      ranks;
   then the doctor: run_doctor(full=True) on the card, every required
   check passed and kernel_build naming the five libraries;
5. timing (information only): the slice's volumes/s, the N4 and CI stages
   (pairwise, densify, ladder) by the host clock; per kernel, its device
   time per call (torch.profiler), its plain version's, the one PyTorch
   call that computes the same function where there is one, and its bound
   (bytes at 3.35 TB/s against float32 operations at 67 TFLOP/s), K1 and
   K2 at every ncp, K4 and K5 on both residuals (K5 also with the L2 cache
   flushed before each call), K3 on the slice's defects (K 512) and on
   severe-load maps at K 2048 and 4096, K9 and K8 on the slice's defects
   and on a severe-load map at K 4096 (K9 with its device activities per
   call, K8 beside the scatter it replaces and the K9 + K8 pair); the fit
   chain's iterations, the cohort's subjects/s, the service's subjects/s
   and one warm arrival's seconds from scan start to its .done; path g's
   calculate_VDP and calculate_CI per study by the host clock; path h's
   predict_mask per 128x128x16 study, train step and analyze --auto-mask
   by the host clock; path i's sharded and unsharded oversize CI and the
   slice on the mesh and as one batch by the host clock, and K3's device
   time on an interior shard (K 4096, Kw 8192) beside the unsharded K3 on
   the whole oversize volume; the dense-field kernel's device time beside
   its plain version's and the 12 bmm it replaced (three a level), and its
   bound; path j's subjects/s for each export mode and for the one-process
   run;
6. with --parent DIR: DIR/n4_fit.cu, DIR/n4_sharpen.cu, DIR/ci_head.cu and
   DIR/ci_densify.cu (an older version of those sources, with the same C
   interfaces; the dense-field kernel is this tree's in both arms) built
   under their own names and timed against this tree in turns (older,
   this, this, older): K1 and K2 at every ncp, K6 and K7 at ncp 11, K4 and K5 on both residuals, K3 at K 512, 2048 and 4096, K9 and
   K8 at K 512 and 4096.  Required bit-equal to them: K4, K5, K3, K9, K8,
   K2's field', logu', min and max, K6's delta and K7's d, and K2's and
   K7's sums (or, where a design moved their order, within KERNEL_RTOL of
   the plain version).  Then the slice on the older kernels and on this
   tree's in turns (its outputs required bit-identical), and one profiled
   batch on the older kernels (chiprun_out/profile_slice_parent.txt);
7. one slice batch under torch.profiler: its device kernels, device time
   and busy share, the rows of K1, K2, K3, K4, K5 and the dense field
   (the table goes to chiprun_out/profile_slice.txt);
8. one JSON line of kernel records (``launches_path_g``,
   ``launches_path_h``, ``launches_path_i``, ``launches_path_j``,
   ``launches_path_k``, ``launches_path_l`` and ``launches_path_m``: each
   kernel's launches in path g, in path h's analyze --auto-mask, in path
   i's entries summed, in path j's ranks and modes summed, in path k, in
   path l's two analysis runs and in path m's analysis runs, every rank's
   window summed (K1's and K4's partial phases counted as K1 and K4; path
   l's split entry points' own counts on the line before),
   ``launches_path_i_by_entry`` by entry; K3's ``path_i_shard`` record;
   ``timed_by_events``: the keys whose times CUDA events took, host launch
   gaps included, where torch.profiler lost the activities), then the
   result line {"ok": true, "device": {...}} last.

It imports nothing of JAX and nothing of the ventjax package.  With
--rank PORT RANK WORLD BACKEND DIR it runs one rank of path i (of path j
where DIR holds a job.json, of path m where it holds a space.json) and
nothing else.
"""
from __future__ import annotations

import contextlib
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
LIBS = ("n4_fit", "n4_sharpen", "ci_head", "ci_densify", "n4_field")
# the libraries an older tree (--parent) is built for: the dense-field kernel
# comes from this tree in both arms of a turn
PARENT_LIBS = LIBS[:4]
FIELD_NCPS = (4, 5, 7, 11)   # N4's levels at the defaults
ADULT_SHAPE = (256, 256, 16)   # the adult cell's geometry, at VOX
ADULT_LANES = 2


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
        + json.dumps({k: round(v, 1)
                      for k, v in _build.BUILD_SECONDS.items()}))


def headline_cohort():
    from ventjax_torch.io.phantom import make_cohort

    hp, mask, _ = make_cohort(BATCH, SHAPE, VOX, seed=SEED)
    max_mask = int((mask > 0).sum(axis=(1, 2, 3)).max())
    n4_pad = min(int(np.prod(SHAPE)), -(-max_mask // 8192) * 8192)
    return hp, mask, n4_pad


def fit_inputs(hp, mask, n4_pad, ncp, dev):
    """The N4 fit operands of a [N, H, W, D] batch at one level: powered
    basis rows of the compacted masked voxels, weights, log values."""
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops.basic import sort_compact_masked

    N, H, W, D = hp.shape
    flat = torch.from_numpy(hp.reshape(N, -1)).to(dev)
    m = torch.from_numpy(mask.reshape(N, -1) > 0).to(dev)
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


FIT_NCPS = (4, 5, 7, 11)   # N4's levels at the defaults: ncp = 2**l + 3


def smooth_residual(wv, gen):
    """A smooth residual on the mask, as N4 fits it."""
    n = wv.shape[1]
    return (torch.sin(torch.linspace(0, 3, n, device=wv.device))[None] * wv
            + 0.01 * torch.from_numpy(gen.normal(size=wv.shape).astype(
                np.float32)).to(wv.device) * wv)


def phase_kernels(hp, mask, n4_pad, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from ventjax_torch.ops import ci_cuda
    from ventjax_torch.ops import ci_pairwise as tcp

    gen = np.random.default_rng(SEED)
    errs = check_fit(hp, mask, n4_pad, dev, gen, freeze=True, k6_k7=True)
    geom = tcp.build_ci_pairwise_geometry(VOX, SHAPE, 50, "wrap")
    for K, shape, lanes in HEAD_SHAPES:
        args = k3_args(severe_coords(K, dev, shape, lanes),
                       ci_geom(shape, geom))
        got = ci_cuda.head_counts(*args)
        want = ci_cuda.head_counts_plain(*args)
        equal = bool(torch.equal(got, want))
        log(f"K3 head_counts K={K} N={lanes} {shape} ns={args[2].shape[0]} "
            f"wrap: bit_equal={equal} max_count={int(want.max())}")
        if not equal:
            raise AssertionError(f"K3 counts differ from the plain version "
                                 f"at K={K}")
    errs["head_counts"] = [0.0]
    check_tail(geom, dev)
    errs["tail_balls"] = [0.0]
    errs.update(check_sharpen(hp, mask, n4_pad, dev))
    errs.update(check_densify(gen, dev))
    check_field(slice_lattices(hp, mask, n4_pad, dev))
    errs["n4_field"] = [0.0]
    return {k: max(v) for k, v in errs.items()}


def slice_lattices(hp, mask, n4_pad, dev):
    """N4's per-level lattices [N, sum ncp^3] of the headline batch."""
    from ventjax_torch.ops import n4 as tn4

    return tn4.n4_bias_correction(
        torch.from_numpy(hp).to(dev), torch.from_numpy(mask).to(dev),
        mask_pad=n4_pad, return_phi=True)[1]


def check_field(phi):
    """The dense-field kernel bit-equal to its plain version on N4's
    lattices of the headline batch (N 16, SHAPE, ncp 4/5/7/11), and each
    lane's field bit-identical in batches of 1, 2, 4, 8 and 16."""
    from ventjax_torch.ops import n4_field_cuda as nf

    got = nf.n4_field(phi, SHAPE, FIELD_NCPS)
    equal = bool(torch.equal(got, nf.n4_field_plain(phi, SHAPE, FIELD_NCPS)))
    relaunch = bool(torch.equal(got, nf.n4_field(phi, SHAPE, FIELD_NCPS)))
    by_n = {}
    for n in (1, 2, 4, 8, 16):
        by_n[n] = all(bool(torch.equal(nf.n4_field(
            phi[i:i + n].contiguous(), SHAPE, FIELD_NCPS), got[i:i + n]))
            for i in range(0, BATCH, n))
    log(f"n4_field N={BATCH} {SHAPE} ncp {FIELD_NCPS}: bit_equal={equal} "
        f"relaunch={relaunch} same bits in batches of "
        f"{json.dumps(by_n)}; max |field| {float(got.abs().max()):.4f}")
    if not (equal and relaunch and all(by_n.values())):
        raise AssertionError("the dense-field kernel differs from its plain "
                             "version or across batch sizes")


def check_fit(hp, mask, n4_pad, dev, gen, freeze, k6_k7):
    """K1 and K2 against their plain versions at every ncp on the N4
    operands of the [N, H, W, D] batch hp, mask (K1 also bit-identical on
    relaunch); with ``freeze`` every third lane of K2 is done and must keep
    its field; with ``k6_k7`` K6 and K7 at ncp 11 too.  Returns the
    largest absolute errors of each kernel, as lists."""
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops import n4_cuda

    N = hp.shape[0]
    errs = {}
    for ncp in FIT_NCPS:
        bv, wv, logv = fit_inputs(hp, mask, n4_pad, ncp, dev)
        r1 = [tn4._rows(b, 1) for b in bv]
        r2 = [tn4._rows(b, 2) for b in bv]
        r3 = [tn4._rows(b, 3) for b in bv]
        a = smooth_residual(wv, gen)
        k1 = {}
        for tag, aa, rows in (("den", wv, r2), ("num", a, r3)):
            got = n4_cuda.fit_moment(aa, *rows)
            want = n4_cuda.fit_moment_plain(aa, *rows)
            k1[tag] = scaled_err(got, want)
            if not torch.equal(got, n4_cuda.fit_moment(aa, *rows)):
                raise AssertionError(f"K1 is not bit-identical on relaunch "
                                     f"(ncp {ncp}, {tag})")
            errs.setdefault("fit_moment", []).append(
                float((got - want).abs().max()))
        phi = torch.from_numpy((0.05 * (1 + 0.2 * gen.normal(
            size=(N, ncp, ncp * ncp)))).astype(np.float32)).to(dev)
        field = 0.01 * torch.from_numpy(gen.normal(
            size=wv.shape).astype(np.float32)).to(dev) * wv
        done = torch.zeros(N, device=dev)
        if freeze:
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
        frozen = bool((got[0][done > 0] == field[done > 0]).all())
        errs.setdefault("fit_delta_conv_field", []).append(
            float((got[0] - want[0]).abs().max()))
        log(f"K1 fit_moment ncp={ncp} N={N} P={n4_pad}: "
            + json.dumps({k: f"{v:.2e}" for k, v in k1.items()}))
        log(f"K2 fit_delta_conv_field ncp={ncp}: "
            + json.dumps({k: f"{v:.2e}" for k, v in k2.items()})
            + f" frozen_lanes_exact={frozen}")
        bad = {k: v for k, v in {**k1, **k2}.items() if not v <= KERNEL_RTOL}
        if bad or not frozen:
            raise AssertionError(f"K1/K2 disagree with their plain versions "
                                 f"at ncp={ncp}: {bad} frozen={frozen}")
        if k6_k7 and ncp == 11:   # the finest level: K6 and K7's shapes
            for k, v in check_fit_delta(phi, r1, wv, logv, s_scale).items():
                errs.setdefault(k, []).append(v)
    return errs


def check_fit_delta(phi, r1, wv, logv, s_scale):
    """K6 and K7 against their plain versions, and K7 bit-equal to the
    flushed, weighted K6 and to K2's delta and sums with done = 0."""
    from ventjax_torch.ops import n4_cuda

    raw = n4_cuda.fit_delta(phi, *r1)
    raw_p = n4_cuda.fit_delta_plain(phi, *r1)
    d, st = n4_cuda.fit_delta_conv(phi, *r1, wv)
    d_p, st_p = n4_cuda.fit_delta_conv_plain(phi, *r1, wv)
    rel = {"K6": scaled_err(raw, raw_p), "K7_d": scaled_err(d, d_p),
           "K7_s1": float(((st[:, 0] - st_p[:, 0]).abs() / s_scale).max()),
           "K7_s2": float(((st[:, 1] - st_p[:, 1]).abs()
                           / st_p[:, 1].abs()).max())}
    flushed = torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw) * wv
    zero = torch.zeros_like(wv)
    nf, _, k2 = n4_cuda.fit_delta_conv_field(
        phi, *r1, wv, zero, logv, torch.zeros(wv.shape[0], device=wv.device))
    same = {"K7_d_eq_flush_K6_wv": bool(torch.equal(d, flushed)),
            "K7_d_eq_K2": bool(torch.equal(d, nf)),
            "K7_s_eq_K2": bool(torch.equal(st, k2[:, :2]))}
    log(f"K6 fit_delta / K7 fit_delta_conv ncp=11 N={wv.shape[0]} "
        f"P={wv.shape[1]}: " + json.dumps({k: f"{v:.2e}"
                                           for k, v in rel.items()})
        + " " + json.dumps(same))
    bad = {k: v for k, v in rel.items() if not v <= KERNEL_RTOL}
    if bad or not all(same.values()):
        raise AssertionError(f"K6/K7 disagree: {bad} {same}")
    return {"fit_delta": float((raw - raw_p).abs().max()),
            "fit_delta_conv": float((d - d_p).abs().max())}


def sharpen_inputs(hp, mask, n4_pad, dev):
    """N4's first sharpen operands on the headline cohort: the log values,
    weights, finest-level normaliser sv, range and slope."""
    from ventjax_torch.ops import n4 as tn4

    bv, wv, logv = fit_inputs(hp, mask, n4_pad, 11, dev)
    sv = (bv[0] ** 2).sum(2) * (bv[1] ** 2).sum(2) * (bv[2] ** 2).sum(2)
    bmn, bmx = tn4._masked_range(logv, wv)
    return logv, wv, sv, bmn, (bmx - bmn) / (BINS - 1)


def expectation(hist, bmn, slope):
    from ventjax_torch.config import DEFAULT_CONFIG as c
    from ventjax_torch.ops import n4 as tn4

    padded = tn4._next_pow2_padded(BINS)
    return tn4._sharpen_expectation(hist, bmn, slope, BINS, c.n4_bias_fwhm,
                                    c.n4_wiener_noise, padded,
                                    (padded - BINS) // 2)


LATE_LEVEL = 0       # N4's first level (ncp 4), 27 iterations on the slice
LATE_ITERS = 12


def late_residual(hp, mask, n4_pad, dev):
    """The sharpen operands late in a level's loop: LATE_ITERS N4
    iterations of level LATE_LEVEL run here with the port's own functions
    (sharpen_hist -> _sharpen_expectation -> sharpen_resid -> fit_moment ->
    fit_delta_conv_field, as ops/n4.py chains them); returns the last
    (logu, wv, sv, binmin, slope)."""
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops import n4_cuda
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    bv, wv, logv = fit_inputs(hp, mask, n4_pad, 2 ** LATE_LEVEL + 3, dev)
    sv = (bv[0] ** 2).sum(2) * (bv[1] ** 2).sum(2) * (bv[2] ** 2).sum(2)
    r1, r2, r3 = ([tn4._rows(b, k) for b in bv] for k in (1, 2, 3))
    den = n4_cuda.fit_moment(wv, *r2)
    den_nz = den != 0.0
    den_safe = torch.where(den_nz, den, torch.ones_like(den))
    field = torch.zeros_like(wv)
    done = torch.zeros(wv.shape[0], device=dev)
    logu = logv * wv
    bmn, bmx = tn4._masked_range(logu, wv)
    for _ in range(LATE_ITERS):
        slope = (bmx - bmn) / (BINS - 1)
        hist = sc.sharpen_hist(logu, wv, bmn, slope, BINS)
        a = sc.sharpen_resid(logu, wv, sv, expectation(hist, bmn, slope),
                             bmn, slope, BINS)
        num = n4_cuda.fit_moment(a, *r3)
        phi = torch.where(den_nz, num / den_safe, torch.zeros_like(num))
        field, logu, stats = n4_cuda.fit_delta_conv_field(
            phi, *r1, wv, field, logv, done)
        bmn, bmx = stats[:, 2].contiguous(), stats[:, 3]
    return logu, wv, sv, bmn, (bmx - bmn) / (BINS - 1)


def mass_err(hist, wv):
    return float((hist.double().sum(1) - wv.double().sum(1)).abs().max())


def hist_f64(logu, wv, bmn, slope):
    """K4's plain version with its float32 contributions summed in float64:
    the histogram that K4 and its float32 plain version both round."""
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    i0, f = sc._split(sc._t_index(logu, wv, bmn, slope, BINS), BINS)
    hist = torch.zeros((logu.shape[0], BINS + 2), dtype=torch.float64,
                       device=logu.device)
    hist.scatter_add_(1, i0, (wv * (1.0 - f)).double())
    hist.scatter_add_(1, i0 + 1, (wv * f).double())
    return hist[:, :BINS]


def check_sharpen(hp, mask, n4_pad, dev):
    """K4 and K5 against their plain versions at the given shapes, on the
    first iteration's residual and on a late one: K4 within KERNEL_RTOL of
    the largest bin of its plain version summed in float64 (the float32
    plain version's own summation error, logged beside it, passes 1e-5 on
    one lane of 65,536 voxels), bit-equal to its exact fixed-point plain
    version and to itself on relaunch; K5 bit-equal."""
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    errs = {"sharpen_hist": [], "sharpen_resid": []}
    for tag, (logu, wv, sv, bmn, slope) in (
            ("first", sharpen_inputs(hp, mask, n4_pad, dev)),
            ("late", late_residual(hp, mask, n4_pad, dev))):
        got = sc.sharpen_hist(logu, wv, bmn, slope, BINS)
        again = sc.sharpen_hist(logu, wv, bmn, slope, BINS)
        want = sc.sharpen_hist_plain(logu, wv, bmn, slope, BINS)
        exact = hist_f64(logu, wv, bmn, slope)
        k4 = scaled_err(got, exact)
        same = {"relaunch": bool(torch.equal(got, again)),
                "fixed_plain": bool(torch.equal(
                    got, sc.sharpen_hist_fixed_plain(logu, wv, bmn, slope,
                                                     BINS)))}
        log(f"K4 sharpen_hist {tag} residual N={wv.shape[0]} P={n4_pad} "
            f"bins={BINS}: rel {k4:.2e} to the float64 sum (the float32 "
            f"plain version's {scaled_err(want, exact):.2e}) bit_identical "
            f"{json.dumps(same)} mass_err {mass_err(got, wv):.2e}")
        if not (k4 <= KERNEL_RTOL and all(same.values())):
            raise AssertionError(f"K4 on the {tag} residual: rel {k4}, "
                                 f"{same}")
        e_loc = expectation(got, bmn, slope)
        a = sc.sharpen_resid(logu, wv, sv, e_loc, bmn, slope, BINS)
        a_plain = sc.sharpen_resid_plain(logu, wv, sv, e_loc, bmn, slope,
                                         BINS)
        k5 = float((a - a_plain).abs().max())
        log(f"K5 sharpen_resid {tag} residual: bit_equal="
            f"{bool(torch.equal(a, a_plain))} max_abs {k5:.2e} "
            f"finite={bool(torch.isfinite(a).all())}")
        if not torch.equal(a, a_plain):
            raise AssertionError(f"K5 differs from its plain version: {k5}")
        errs["sharpen_hist"].append(float((got.double() - exact).abs().max()))
        errs["sharpen_resid"].append(k5)
    return errs


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
    check_rank_shapes(gen, dev)
    return {"rank": [0.0], "densify_rank": [0.0]}


def check_rank_shapes(gen, dev):
    """K9 bit-equal to its plain version at ragged V, on rows whose flags
    lie only in their last tile, and the same again right after a call of
    another shape (the look-back workspace is left zero by every call)."""
    from ventjax_torch.ops import ci_densify_cuda as cd

    V = int(np.prod(SHAPE))
    tile = cd._lib().vj_rank_tile()
    last = np.zeros((BATCH, V), bool)
    start = (V - 1) // tile * tile
    last[:, start:] = gen.random((BATCH, V - start)) < 0.5
    cases = [(f"V={v}", gen.random((BATCH, v)) < 0.05)
             for v in (4112, 100003)] + [("last tile only", last)]
    other = torch.from_numpy(gen.random((3, 7777)) < 0.3).to(dev)
    for tag, d in cases:
        d = torch.from_numpy(d).to(dev)
        want = cd.rank_plain(d)
        first = torch.equal(cd.rank(d), want)
        cd.rank(other)
        again = torch.equal(cd.rank(d), want)
        log(f"K9 rank {tag} N={BATCH}: bit_equal={first}, after a call of "
            f"another shape {again}")
        if not (first and again):
            raise AssertionError(f"K9 differs from its plain version: {tag}")


def severe_defects(K, gen, shape=SHAPE, lanes=BATCH):
    """[lanes, H, W, D] defect maps of severe disease: clustered blobs
    until each lane holds ~3/4 of K defect voxels.  Blob radii scale with
    the matrix (3-10 voxels in-plane at 128, 6-20 at the adult's 256)."""
    H, W, D = shape
    f = H / SHAPE[0]
    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                             indexing="ij")
    out = np.zeros((lanes,) + shape, np.float32)
    for n in range(lanes):
        while out[n].sum() < 0.75 * K:
            c = gen.uniform([20 * f, 20 * f, 0], [H - 20 * f, W - 20 * f, D])
            r = gen.uniform([3 * f, 3 * f, 1], [10 * f, 10 * f, 3])
            blob = (((ii - c[0]) / r[0]) ** 2 + ((jj - c[1]) / r[1]) ** 2
                    + ((kk - c[2]) / r[2]) ** 2) <= 1.0
            out[n][blob & (gen.random(shape) < 0.8)] = 1.0
    return out


_SEVERE = {}


def severe_map(K, dev, shape=SHAPE, lanes=BATCH):
    """A severe-load batch of defect maps for pad K (made once per K, shape
    and lane count, from SEED + K)."""
    if (K, shape, lanes) not in _SEVERE:
        gen = np.random.default_rng(SEED + K)
        _SEVERE[K, shape, lanes] = torch.from_numpy(
            severe_defects(K, gen, shape, lanes)).to(dev)
    return _SEVERE[K, shape, lanes]


def severe_coords(K, dev, shape=SHAPE, lanes=BATCH):
    """Defect coordinates, as calculate_ci_pairwise builds them, of
    severe_map(K, dev, shape, lanes)."""
    from ventjax_torch.ops.ci_pairwise import defect_coords

    return defect_coords(severe_map(K, dev, shape, lanes), K)[0]


_GEOMS = {}


def ci_geom(shape, geom):
    """The CI pairwise geometry (VOX, rmax 50, wrap) of shape: geom itself
    at SHAPE, else built once."""
    from ventjax_torch.ops import ci_pairwise as tcp

    if shape == SHAPE:
        return geom
    if shape not in _GEOMS:
        _GEOMS[shape] = tcp.build_ci_pairwise_geometry(VOX, shape, 50,
                                                       "wrap")
    return _GEOMS[shape]


def engine_tail(defect, geom, K, tail_k=None):
    """The arguments the CI engine hands K10 (``tail_balls``) at pad K:
    the head's unresolved rows compacted to the tail, then sentinels."""
    from ventjax_torch.ops import ci_pairwise as tcp

    seen, real = [], tcp.tail_balls

    def spy(*args):
        seen.append(args)
        return real(*args)
    tcp.tail_balls = spy
    try:
        tcp.calculate_ci_pairwise(defect, geom, K, tail_k=tail_k)
    finally:
        tcp.tail_balls = real
    return seen[0]


# K10's shapes in the three benchmark cells, (pad, tail_k, shape, lanes):
# the cohort's tail (pad 512, 256 tail rows), the severe cohort's (pad
# 8,192, the tail at full width) and the adult cell's (pad 32,768 at
# 256x256x16, the tail at full width; two lanes keep the plain sort path
# under two seconds a call).
TAIL_SHAPES = ((512, None, SHAPE, BATCH), (8192, 8192, SHAPE, BATCH),
               (32768, 32768, ADULT_SHAPE, ADULT_LANES))
# K3's shapes held bit-equal to its plain version, (pad = witnesses, shape,
# lanes): severe-load maps at 128x128x16, and the adult cell's pad.
HEAD_SHAPES = ((1024, SHAPE, BATCH), (2048, SHAPE, BATCH),
               (4096, SHAPE, BATCH), (32768, ADULT_SHAPE, ADULT_LANES))


def check_tail(geom, dev):
    """K10 at the three cells' tail shapes, on severe-load maps: one launch
    each, bit-equal to its plain version (the sort path) and to a
    relaunch."""
    from ventjax_torch.ops import ci_cuda

    for K, tail_k, shape, lanes in TAIL_SHAPES:
        args = engine_tail(severe_map(K, dev, shape, lanes),
                           ci_geom(shape, geom), K, tail_k)
        before = ci_cuda.LAUNCHES["tail_balls"]
        got = ci_cuda.tail_balls(*args)
        launched = ci_cuda.LAUNCHES["tail_balls"] - before
        equal = bool(torch.equal(got, ci_cuda.tail_balls_plain(*args))) \
            and bool(torch.equal(got, ci_cuda.tail_balls(*args)))
        log(f"K10 tail_balls N={args[0][0].shape[0]} rows="
            f"{args[0][0].shape[1]} Kw={args[1][0].shape[1]} "
            f"nb={args[2].shape[0]}: bit_equal={equal} launches={launched}")
        if not equal or launched != 1:
            raise AssertionError(f"K10 differs from its plain version or "
                                 f"did not launch at pad {K}")


def tail_records(geom, dev):
    """K10's device ms at the three cells' tail shapes beside its plain
    version's (by CUDA events: at the severe tail one call is ~8,000
    launches and ~0.8 s, too many activities for a profiler session and
    too long for launch gaps to matter) and its bound (K3's: 8 float32
    operations a box distance)."""
    from ventjax_torch.ops import ci_cuda

    by_k = {}
    for K, tail_k, shape, lanes in TAIL_SHAPES:
        args = engine_tail(severe_map(K, dev, shape, lanes),
                           ci_geom(shape, geom), K, tail_k)
        N, rows = args[0][0].shape
        b = bound(N * (rows * 20 + args[1][0].shape[1] * 12),
                  8 * k3_box_distances(*args[:2], None, *args[4:]))
        by_k[f"K{K}"] = {
            "ms": device_ms(lambda: ci_cuda.tail_balls(*args)),
            "plain_ms": cuda_ms(lambda: ci_cuda.tail_balls_plain(*args),
                                reps=3),
            "library_ms": None, "bound_ms": b[0], "bound_by": b[1]}
    return by_k


def k3_args(coords, geom):
    """K3's arguments for centers = witnesses = coords on geom."""
    from ventjax_torch.ops import ci_pairwise as tcp

    ns = min(96, geom.n_balls - 1)
    r2 = torch.as_tensor(geom.r2_32[:ns], device=coords[0].device)
    return (coords, coords, r2, tcp._alias_combos(geom), geom.scale,
            geom.rmax)


def counters():
    from ventjax_torch.ops import (ci_cuda, ci_densify_cuda, n4, n4_cuda,
                                   n4_field_cuda, n4_sharpen_cuda)

    return (n4_cuda.LAUNCHES, n4_sharpen_cuda.LAUNCHES, ci_cuda.LAUNCHES,
            ci_densify_cuda.LAUNCHES, n4_field_cuda.LAUNCHES, n4.HOST_SYNCS)


def reset_counts():
    for d in counters():
        for k in d:
            d[k] = 0


# N4's captures and replays of an iteration's graph (ops/n4.py), which sit
# in n4_cuda.LAUNCHES beside the launches but are none
GRAPH_COUNTERS = ("n4_iter_graph_captures", "n4_iter_graph_replays")


def launch_counts():
    return {k: v for d in counters()[:-1] for k, v in d.items()
            if k not in GRAPH_COUNTERS}


def graph_counts():
    return {k: counters()[0][k] for k in GRAPH_COUNTERS}


def graph_deltas(before):
    """N4's captures and replays since ``before`` (a ``graph_counts``)."""
    return {k: v - before[k] for k, v in graph_counts().items()}


def phase_slice(hp, mask, n4_pad, dev):
    from ventjax_torch.config import DEFAULT_CONFIG
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
    log(f"slice launches: {json.dumps(launches)}; N4 host syncs: {syncs}; "
        f"N4 graphs: {json.dumps(graph_counts())}")
    path = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
            "sharpen_resid", "head_counts", "tail_balls", "n4_field")
    if not all(launches[k] > 0 for k in path):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
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


FIT_LEVEL = 3       # N4's finest level at the defaults: ncp = 2**3 + 3
FIT_ITERS = 20


def fit_chain(moment, delta, wv, rows, r, iters=FIT_ITERS):
    """The unfused B-spline fit loop of benchmarks/n4_pallas_micro.py from
    the residual r: den = moment(wv, rows^2); per iteration num =
    moment(r, rows^3), phi = num / den, delta = B phi, r -= 1e-6 delta wv.
    Returns the last residual, delta and phi."""
    r1, r2, r3 = rows
    den = moment(wv, *r2)
    for _ in range(iters):
        num = moment(r, *r3)
        phi = torch.where(den != 0.0,
                          num / torch.where(den != 0.0, den,
                                            torch.ones_like(den)),
                          torch.zeros_like(den))
        d = delta(phi, *r1)
        r = r - 1e-6 * d * wv
    return r, d, phi


def phase_fit_chain(hp, mask, n4_pad, dev):
    """Path c: the unfused fit chain through K1 and K6 (and one K7), held
    against the same chain through the plain versions."""
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops import n4_cuda

    ncp = 2 ** FIT_LEVEL + 3
    bv, wv, logv = fit_inputs(hp, mask, n4_pad, ncp, dev)
    rows = tuple([tn4._rows(b, k) for b in bv] for k in (1, 2, 3))
    torch.cuda.synchronize()
    reset_counts()
    r, d, phi = fit_chain(n4_cuda.fit_moment, n4_cuda.fit_delta, wv, rows,
                          logv)
    dc, stats = n4_cuda.fit_delta_conv(phi, *rows[0], wv)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"fit chain launches (level {FIT_LEVEL}, ncp {ncp}, {FIT_ITERS} "
        f"iterations): {json.dumps(launches)}")
    want = {"fit_moment": FIT_ITERS + 1, "fit_delta": FIT_ITERS,
            "fit_delta_conv": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"fit chain launches {launches}, want {want}")
    r_p, d_p, phi_p = fit_chain(n4_cuda.fit_moment_plain,
                                n4_cuda.fit_delta_plain, wv, rows, logv)
    dc_p, _ = n4_cuda.fit_delta_conv_plain(phi_p, *rows[0], wv)
    rel = {"residual": scaled_err(r, r_p), "delta": scaled_err(d, d_p),
           "phi": scaled_err(phi, phi_p), "K7_d": scaled_err(dc, dc_p)}
    finite = bool(torch.isfinite(r).all() and torch.isfinite(stats).all())
    log(f"fit chain vs plain chain: "
        + json.dumps({k: f"{v:.2e}" for k, v in rel.items()})
        + f" finite={finite}")
    if not finite or not all(v <= KERNEL_RTOL for v in rel.values()):
        raise AssertionError(f"the fit chain differs from its plain chain: "
                             f"{rel} finite={finite}")
    ms = {"kernels": cuda_ms(lambda: fit_chain(
        n4_cuda.fit_moment, n4_cuda.fit_delta, wv, rows, logv), reps=3),
          "plain": cuda_ms(lambda: fit_chain(
              n4_cuda.fit_moment_plain, n4_cuda.fit_delta_plain, wv, rows,
              logv), reps=3)}
    log(f"time fit chain per iteration (N {BATCH}, P {n4_pad}): kernels "
        f"{ms['kernels'] / FIT_ITERS:.4f} ms, plain "
        f"{ms['plain'] / FIT_ITERS:.4f} ms")
    return {k: launches[k] for k in ("fit_delta", "fit_delta_conv")}


def phase_ladder(cfg, res, hp_d, mask_d):
    """Path d: the gather-ladder CI engine through analyze_cohort, bit-equal
    to the pairwise map; the witness geometry falls back to it."""
    from ventjax_torch.ops.ci import CIGeometry, calculate_ci_staged
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    lcfg = cfg.replace(ci_engine="ladder")
    lgeom = build_geometry(VOX, SHAPE, lcfg)
    witness = build_geometry((3.125, 3.125, 15.0), (32, 32, 6),
                             cfg.replace(ci_rmax=20))
    torch.cuda.synchronize()
    reset_counts()
    lad = analyze_cohort(hp_d, mask_d, lgeom, lcfg)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"ladder path launches: {json.dumps(launches)}")
    _, _, _, stage_ovf = calculate_ci_staged(res.defect, lgeom,
                                             cfg.ci_max_defect_voxels)
    mt = lad.metrics
    checks = {
        "ladder_geometry": isinstance(lgeom, CIGeometry),
        "witness_falls_back": isinstance(witness, CIGeometry),
        "defect_equal": bool(torch.equal(lad.defect, res.defect)),
        "ci_map_equal_pairwise": bool(torch.equal(lad.ci_map, res.ci_map)),
        "ci_equal": bool(torch.equal(mt.ci, res.metrics.ci)),
        "flags_clean": not bool(mt.ci_overflow.any()
                                or mt.n4_overflow.any()) and bool(
                                    mt.valid.all()),
        "stage_overflow_0": int(stage_ovf.max()) == 0,
        "n4_kernels_launched": all(launches[k] > 0 for k in (
            "fit_moment", "fit_delta_conv_field", "sharpen_hist",
            "sharpen_resid")),
    }
    log(f"ladder CI engine on the slice: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the ladder path failed: {checks}")
    return lgeom


COHORT_STUDIES = 32
COHORT_BATCH = 16


def write_cohort(root):
    """COHORT_STUDIES synthetic DICOM studies of SHAPE (study 3 severe:
    more defect voxels than the first CI pad) and an entry whose files do
    not exist; returns the manifest."""
    import os

    from ventjax_torch.io.phantom import make_phantom
    from ventjax_torch.io.synthetic import write_study

    manifest = []
    for i in range(COHORT_STUDIES):
        kw = dict(n_defects=6, defect_radius_vox=(6.0, 8.0, 10.0)) \
            if i == 3 else {}
        ph = make_phantom(shape=SHAPE, vox=VOX, seed=SEED + i, **kw)
        sdir = os.path.join(root, f"study{i:02d}")
        write_study(sdir, phantom=ph, with_proton=False)
        manifest.append({"id": f"s{i:02d}", "xenon": f"{sdir}/xenon.dcm",
                         "mask": f"{sdir}/mask"})
    manifest.insert(5, {"id": "broken", "xenon": f"{root}/none/xenon.dcm",
                        "mask": f"{root}/none/mask"})
    return manifest


def phase_cohort(dev):
    """Path e: the cohort driver at full width, its exports, the retry of
    the severe study, agreement with analyze_cohort, and a resume."""
    import os
    import tempfile

    from ventjax_torch.io import native
    from ventjax_torch.io.nifti import load as nifti_load
    from ventjax_torch.pipeline import analyze_cohort, build_geometry
    from ventjax_torch.pipeline import cohort as tc

    native.available()      # build the native DICOM decoder before timing
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifest = write_cohort(root)
        log(f"cohort: wrote {COHORT_STUDIES} studies of {SHAPE} in "
            f"{time.perf_counter() - t0:.1f} s")
        out = os.path.join(root, "out")
        runners = {}
        analysis_s = []
        graphs = []         # N4's captures and replays, one entry a batch
        dispatch = tc._GeometryRunner.dispatch

        def timed_dispatch(self, batch):
            t, g = time.perf_counter(), graph_counts()
            pack = dispatch(self, batch)
            torch.cuda.synchronize()
            analysis_s.append(time.perf_counter() - t)
            graphs.append(graph_deltas(g))
            return pack

        tc._GeometryRunner.dispatch = timed_dispatch
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = tc.run_cohort(manifest, out, batch_size=COHORT_BATCH,
                                    runners=runners, device=dev)
            wall = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            tc._GeometryRunner.dispatch = dispatch
        (runner,) = runners.values()
        by_id = {r["id"]: r for r in results}
        ids = [e["id"] for e in manifest if e["id"] != "broken"]
        exported = all(all(os.path.exists(os.path.join(out, s, f)) for f in (
            ".done", "metrics.json", f"{s}_dataArray.nii")) for s in ids)
        checks = {
            "exports_written": exported,
            "all_valid_clean": all(
                by_id[s]["valid"] and not by_id[s]["CI_overflow"]
                and not by_id[s]["N4_overflow"] for s in ids),
            "decode_failed": by_id["broken"].get("error") == "decode_failed",
            "severe_retried": runner.ci_bucket > 512
            and len(analysis_s) > COHORT_STUDIES // COHORT_BATCH,
            "device": runner.device.type == "cuda",
            "kernels_launched": all(launches[k] > 0 for k in (
                "fit_moment", "fit_delta_conv_field", "sharpen_hist",
                "sharpen_resid", "head_counts", "n4_field")),
        }
        log(f"cohort launches: {json.dumps(launches)}; final pads ci "
            f"{runner.ci_bucket} n4 {runner.n4_bucket}; batches run "
            f"{len(analysis_s)}")
        log("cohort N4 graphs (captures, replays) a batch: " + json.dumps(
            [[g[k] for k in GRAPH_COUNTERS] for g in graphs]))

        # the first 16 against analyze_cohort on the same decoded volumes
        first = ids[:COHORT_BATCH]
        dec = [tc._decode_subject(e) for e in manifest if e["id"] in first]
        cfg = runner.config.replace(ci_max_defect_voxels=runner.ci_bucket,
                                    n4_mask_pad=runner.n4_bucket)
        direct = analyze_cohort(
            torch.from_numpy(np.stack([d[0].astype(np.float32)
                                       for d in dec])).to(dev),
            torch.from_numpy(np.stack([d[1] for d in dec])).to(dev),
            build_geometry(VOX, SHAPE, cfg), cfg)
        dvdp, ci_ok = 0.0, True
        for i, s in enumerate(first):
            for key, name in (("VDP", "vdp"), ("VDP_lb", "vdp_lb"),
                              ("VDP_km", "vdp_km")):
                dvdp = max(dvdp, abs(by_id[s][key] - float(
                    getattr(direct.metrics, name)[i])))
            data = nifti_load(os.path.join(out, s, f"{s}_dataArray.nii"))[0]
            defect = torch.from_numpy(np.ascontiguousarray(data[..., 4]))
            if torch.equal(defect, direct.defect[i].cpu()):
                ci_ok &= bool(np.array_equal(data[..., 5],
                                             direct.ci_map[i].cpu().numpy()))
        checks["first16_dvdp_lt_0.1"] = dvdp < 0.1
        checks["first16_ci_equal"] = ci_ok
        log(f"cohort vs analyze_cohort, first {COHORT_BATCH}: max |dVDP| "
            f"{dvdp:.3e} pp, CI maps equal where defects agree: {ci_ok}")

        reset_counts()
        t0 = time.perf_counter()
        again = tc.run_cohort(manifest, out, batch_size=COHORT_BATCH,
                              device=dev)
        resume_s = time.perf_counter() - t0
        resumed = launch_counts()
        checks["resume_no_launch"] = not any(resumed.values())
        # the compact pack (the default) against the dense one (cohort
        # --dense-export) on the same studies, in turns (compact, dense,
        # dense, compact), each run's runner seeded with the first run's
        # final pads: the retry's timing, which can move a lane's N4 pad
        # and so its bits, is then out of the comparison
        (geo,) = runners

        def seeded(compact):
            r = tc._GeometryRunner(runner.shape, runner.vox, runner.config,
                                   COHORT_BATCH, device=dev,
                                   compact_export=compact)
            r.ci_bucket, r.n4_bucket = runner.ci_bucket, runner.n4_bucket
            r.ci_tail_full = runner.ci_tail_full
            return {geo: r}

        pack_s = {True: [], False: []}
        for turn, compact in enumerate((True, False, False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tc.run_cohort(manifest, os.path.join(root, f"pack{turn}"),
                          batch_size=COHORT_BATCH, device=dev,
                          runners=seeded(compact), compact_export=compact)
            pack_s[compact].append(time.perf_counter() - t0)
        n4_rel, differ = 0.0, []
        for s in ids:
            a = nifti_load(os.path.join(root, "pack0", s,
                                        f"{s}_dataArray.nii"))[0]
            b = nifti_load(os.path.join(root, "pack1", s,
                                        f"{s}_dataArray.nii"))[0]
            m = b[..., 2] > 0
            for what, same in (
                    ("defect", np.array_equal(a[..., 4], b[..., 4])),
                    ("ci", np.array_equal(a[..., 5], b[..., 5])),
                    ("masked_n4", np.array_equal(a[..., 3][m],
                                                 b[..., 3][m])),
                    ("metrics", open(os.path.join(
                        root, "pack0", s, "metrics.json")).read() == open(
                            os.path.join(root, "pack1", s,
                                         "metrics.json")).read())):
                if not same:
                    differ.append(f"{s}:{what}")
            n4_rel = max(n4_rel, float(np.max(np.abs(a[..., 3] - b[..., 3])
                                              / np.maximum(np.abs(b[..., 3]),
                                                           1e-6))))
        checks["compact_equals_dense"] = not differ
        log(f"cohort compact vs dense pack (seeded pads ci "
            f"{runner.ci_bucket} n4 {runner.n4_bucket}): differing "
            f"{differ}, N4 background max relative difference {n4_rel!r}")
        checks["compact_background_within_1e-5"] = n4_rel < 1e-5
        checks["resume_all"] = len(again) == len(manifest) and all(
            r.get("error") == "decode_failed" or r["id"] in ids
            for r in again)
        log(f"cohort checks: {json.dumps(checks)}")
        if not all(checks.values()):
            raise AssertionError(f"the cohort path failed: {checks}")
        rate = COHORT_STUDIES / wall
        share = sum(analysis_s) / wall
        log(f"time cohort: {wall:.2f} s for {COHORT_STUDIES} subjects -> "
            f"{rate:.2f} subjects/s end to end (decode, analysis, export); "
            f"analysis {sum(analysis_s):.2f} s, share {share:.3f} (batches "
            f"s: {[round(t, 3) for t in analysis_s]}); resume {resume_s:.2f}"
            f" s; subjects/s by pack at the final pads, in turns (compact, "
            f"dense, dense, compact): compact "
            f"{[COHORT_STUDIES / t for t in pack_s[True]]!r}, dense "
            f"{[COHORT_STUDIES / t for t in pack_s[False]]!r}")
    return rate


SERVE_STUDIES = 16


def back_date(root, seconds=3600.0):
    """Set every file's mtime under root to seconds ago (a settled
    arrival)."""
    import os

    past = time.time() - seconds
    for r, _d, files in os.walk(root):
        for f in files:
            os.utime(os.path.join(r, f), (past, past))


def phase_serve(dev):
    """Path f: the watch-folder service at full width on the card: warm
    runner across scans, exactly-once, arrival gating, failure isolation
    and retry, the scan watchdog; metrics against analyze_cohort.  Returns
    (scan 1's subjects/s, one warm arrival's seconds to its .done)."""
    import os
    import tempfile

    from ventjax_torch.io.synthetic import write_study
    from ventjax_torch.pipeline import analyze_cohort, build_geometry
    from ventjax_torch.pipeline import cohort as tc
    from ventjax_torch.pipeline import serve as serve_mod

    path = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
            "sharpen_resid", "head_counts")
    with tempfile.TemporaryDirectory() as root:
        inbox, out = os.path.join(root, "inbox"), os.path.join(root, "out")
        t0 = time.perf_counter()
        for i in range(SERVE_STUDIES):
            sdir = os.path.join(inbox, f"f{i:02d}")
            write_study(sdir, shape=SHAPE, vox=VOX, seed=SEED + 100 + i,
                        with_proton=False)
            back_date(sdir)
        log(f"serve: wrote {SERVE_STUDIES} studies of {SHAPE} in "
            f"{time.perf_counter() - t0:.1f} s")
        svc = serve_mod.WatchService(inbox, out, batch_size=SERVE_STUDIES,
                                     min_age=1.0, retry_backoff=0.0,
                                     device=dev)
        warm_s = svc.prewarm([(SHAPE, VOX)])
        (runner,) = svc.runners.values()
        batches = []
        graphs = []         # N4's captures and replays, one entry a batch
        dispatch = tc._GeometryRunner.dispatch

        def counted_dispatch(self, batch):
            batches.append(len(batch))
            g = graph_counts()
            pack = dispatch(self, batch)
            graphs.append(graph_deltas(g))
            return pack

        tc._GeometryRunner.dispatch = counted_dispatch
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            r1 = svc.scan_once()
            scan1_s = time.perf_counter() - t0
            launches1 = launch_counts()
        finally:
            tc._GeometryRunner.dispatch = dispatch
        ids = [f"f{i:02d}" for i in range(SERVE_STUDIES)]
        checks = {
            "scan1_all_analyzed": (r1.new, r1.analyzed, r1.failed)
            == (SERVE_STUDIES, SERVE_STUDIES, 0),
            "scan1_one_batch": batches == [SERVE_STUDIES],
            "scan1_kernels_launched": all(launches1[k] > 0 for k in path),
            "done_markers": all(os.path.exists(os.path.join(out, s, ".done"))
                                for s in ids),
        }
        log(f"serve scan 1: {json.dumps(r1.as_dict())}; batches {batches}; "
            f"launches {json.dumps(launches1)}; pads ci {runner.ci_bucket} "
            f"n4 {runner.n4_bucket}")

        # every study against analyze_cohort on the same decoded volumes
        dec = [tc._decode_subject({"xenon": os.path.join(inbox, s,
                                                         "xenon.dcm"),
                                   "mask": os.path.join(inbox, s, "mask")})
               for s in ids]
        cfg = runner.config.replace(ci_max_defect_voxels=runner.ci_bucket,
                                    n4_mask_pad=runner.n4_bucket)
        direct = analyze_cohort(
            torch.from_numpy(np.stack([d[0].astype(np.float32)
                                       for d in dec])).to(dev),
            torch.from_numpy(np.stack([d[1] for d in dec])).to(dev),
            build_geometry(VOX, SHAPE, cfg), cfg)
        dvdp = 0.0
        for i, s in enumerate(ids):
            m = json.load(open(os.path.join(out, s, "metrics.json")))
            for key, name in (("VDP", "vdp"), ("VDP_lb", "vdp_lb"),
                              ("VDP_km", "vdp_km")):
                dvdp = max(dvdp, abs(m[key] - float(
                    getattr(direct.metrics, name)[i])))
        checks["dvdp_lt_0.1"] = dvdp < 0.1

        reset_counts()
        r2 = svc.scan_once()
        checks["scan2_nothing_new"] = (r2.new, r2.analyzed) == (0, 0)
        checks["scan2_no_launch"] = not any(launch_counts().values())

        late = os.path.join(inbox, "late")
        write_study(late, shape=SHAPE, vox=VOX, seed=SEED + 200,
                    with_proton=False)
        back_date(late, 0.0)   # just arrived
        r3 = svc.scan_once()
        checks["fresh_arrival_pending"] = (r3.pending, r3.analyzed) == (1, 0)
        back_date(late, 60.0)
        t_scan, g = time.time(), graph_counts()
        r4 = svc.scan_once()
        arrival_s = os.path.getmtime(os.path.join(out, "late", ".done")) \
            - t_scan
        log("serve N4 graphs (captures, replays): scan 1 a batch "
            + json.dumps([[b[k] for k in GRAPH_COUNTERS] for b in graphs])
            + ", the late arrival " + json.dumps(
                [graph_deltas(g)[k] for k in GRAPH_COUNTERS]))
        checks["arrival_analyzed_warm"] = (r4.analyzed == 1
                                           and len(svc.runners) == 1
                                           and svc.runners[runner.shape,
                                                           runner.vox]
                                           is runner)

        bad = os.path.join(inbox, "bad")
        os.makedirs(os.path.join(bad, "mask"))
        with open(os.path.join(bad, "xenon.dcm"), "wb") as f:
            f.write(b"\x00" * 256)
        back_date(bad)
        r5 = svc.scan_once()
        status = json.load(open(os.path.join(out, "serve_status.json")))
        checks["corrupt_fails_alone"] = (r5.new, r5.failed, r5.analyzed) \
            == (1, 1, 0) and status["awaiting_retry"] == ["bad"]
        r6 = svc.scan_once()
        checks["corrupt_retried"] = (r6.retried, r6.failed) == (1, 1)

        fired = []
        exit_fn = serve_mod._watchdog_exit
        serve_mod._watchdog_exit = fired.append
        try:
            n = svc.serve_forever(interval=0.01, max_scans=2,
                                  scan_timeout=600.0)
        finally:
            serve_mod._watchdog_exit = exit_fn
        checks["serve_forever_watchdog_quiet"] = n == 2 and fired == []
        log(f"serve checks: {json.dumps(checks)}; max |dVDP| vs "
            f"analyze_cohort {dvdp:.3e} pp")
        if not all(checks.values()):
            raise AssertionError(f"the serve path failed: {checks}")
        rate = SERVE_STUDIES / scan1_s
        log(f"time serve: prewarm {warm_s:.2f} s; scan 1 {scan1_s:.2f} s for "
            f"{SERVE_STUDIES} subjects -> {rate:.2f} subjects/s (decode, "
            f"analysis, export); warm arrival {arrival_s:.2f} s from scan "
            f"start to its .done")
    return rate, arrival_s


FACADE_RECIPE = "close:1,fillholes,erode:1"


def facade_studies(root):
    """Path g's two studies of SHAPE: a typical one and a severe one
    (large clustered defects, whose CI pad reaches K >= 2048)."""
    import os

    from ventjax_torch.io.phantom import make_phantom
    from ventjax_torch.io.synthetic import write_study

    studies = {}
    for name, kw in (("typical", {}),
                     ("severe", dict(n_defects=8,
                                     defect_radius_vox=(8.0, 10.0, 12.0)))):
        sdir = os.path.join(root, name)
        write_study(sdir, phantom=make_phantom(shape=SHAPE, vox=VOX,
                                               seed=SEED + 300, **kw))
        studies[name] = {"xenon_path": f"{sdir}/xenon.dcm",
                         "mask_path": f"{sdir}/mask",
                         "proton_path": f"{sdir}/proton.dcm"}
    return studies


def png_ok(path):
    """A PNG that Pillow decodes to a non-empty RGB(A) image."""
    from PIL import Image

    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            return False
    with Image.open(path) as im:
        im.load()
        return im.size[0] > 0 and im.size[1] > 0


def run_cli(argv):
    """(exit code, stdout, stderr) of ventjax_torch.cli.main(argv)."""
    import io

    from ventjax_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    return rc, out.getvalue(), err.getvalue()


def phase_facade(dev):
    """Path g: the reference's Vent_Analysis class on the card (its default
    device) over two written studies, its mask editing, every export read
    back, TWIX recon, and the analyze / export / twix commands; then the
    facade's metrics against analyze_study on the same arrays.  Returns
    its launch counts, host-clock timings and the kernels' largest errors
    against their plain versions at the shapes path g gave them."""
    import importlib.util
    import os
    import tempfile

    from ventjax_torch.compat import Vent_Analysis
    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.io import dicom as dcm
    from ventjax_torch.io.nifti import load as nifti_load
    from ventjax_torch.io.twix import write_synthetic_twix
    from ventjax_torch.pipeline import analyze_study, build_geometry

    has_pil = importlib.util.find_spec("PIL") is not None
    n4_path = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
               "sharpen_resid")
    checks, times, facades = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        studies = facade_studies(root)
        log(f"facade: wrote 2 studies of {SHAPE} in "
            f"{time.perf_counter() - t0:.1f} s; Pillow importable: {has_pil}")
        torch.cuda.synchronize()
        reset_counts()
        for name, paths in studies.items():
            k3_before = counters()[2]["head_counts"]
            v = Vent_Analysis(**paths)
            t = time.perf_counter()
            v.calculate_VDP()
            torch.cuda.synchronize()
            t_vdp = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            v.calculate_CI()
            torch.cuda.synchronize()
            t_ci = (time.perf_counter() - t) * 1e3
            first_n4 = v.N4HPvent.copy()
            v.calculate_VDP()
            times[name] = {"calculate_VDP_ms": round(t_vdp, 3),
                           "calculate_CI_ms": round(t_ci, 3)}
            checks[f"{name}_device_cuda"] = v.device.type == "cuda"
            checks[f"{name}_k3_launched"] = \
                counters()[2]["head_counts"] > k3_before
            checks[f"{name}_n4_repeat_bit_identical"] = np.array_equal(
                first_n4, v.N4HPvent)
            checks[f"{name}_finite"] = all(np.isfinite(float(
                v.metadata[k])) for k in ("SNR", "VDP", "VDP_lb",
                                           "VDP_km", "CI"))
            facades[name] = v
            log(f"facade {name}: defect voxels "
                f"{int(v.defectArray.sum())}; VDP "
                f"{v.metadata['VDP']:.4f} VDP_lb "
                f"{v.metadata['VDP_lb']:.4f} VDP_km "
                f"{v.metadata['VDP_km']:.4f} CI {v.metadata['CI']:.4f}")
        v = facades["typical"]

        # mask editing on the card against the same recipe on the CPU
        on_cpu = Vent_Analysis(**studies["typical"], device="cpu")
        edited = Vent_Analysis(**studies["typical"])
        checks["edit_mask_equals_cpu"] = np.array_equal(
            edited.editMask(FACADE_RECIPE), on_cpu.editMask(FACADE_RECIPE)) \
            and edited.metadata["LungVolume"] == on_cpu.metadata["LungVolume"]

        # every export, read back with the port's codecs
        out = os.path.join(root, "exports")
        os.makedirs(out)
        nii = v.exportNifti(out, "g")
        checks["nifti_defect_channel"] = np.array_equal(
            nifti_load(nii)[0][..., 4], v.defectArray)
        hdr = json.load(open(v.dicom_to_json(v.ds, os.path.join(out,
                                                                "g.json"))))
        checks["header_json"] = "PatientName" in json.dumps(hdr)
        pkl = v.pickleMe(os.path.join(out, "g.pkl"))
        npz = v.saveNpz(os.path.join(out, "g.npz"))
        red_ok = True
        for tag, compress in (("plain", False), ("rle", True)):
            os.makedirs(os.path.join(out, tag))
            ddir = v.exportDICOM(v.ds, os.path.join(out, tag), "g",
                                 compress=compress)
            for i in range(SHAPE[2]):
                rgb = dcm.read_file(os.path.join(ddir, f"dicom_{i}.dcm")
                                    ).pixel_array.astype(np.int32)
                red = (rgb[..., 0] == 255) & (rgb[..., 1] == 0) \
                    & (rgb[..., 2] == 0)
                gray = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1]
                                                       == rgb[..., 2])
                dmask = v.defectArray[:, :, i] == 1
                red_ok &= bool(np.all(red[dmask]) and np.all(gray[~dmask]))
        checks["overlay_red_exactly_at_defects"] = red_ok
        keys = ("SNR", "VDP", "VDP_lb", "VDP_km", "CI", "LungVolume")
        for tag, kw in (("npz", {"npz_path": npz}),
                        ("pickle", {"pickle_path": pkl})):
            back = Vent_Analysis(**kw)
            checks[f"{tag}_restores_metrics"] = all(
                float(back.metadata[k]) == float(v.metadata[k])
                for k in keys) and np.array_equal(back.defectArray,
                                                  v.defectArray)

        # TWIX: process_RAW on the card against numpy's float64 recon
        gen = np.random.default_rng(SEED + 301)
        kspace = (gen.normal(size=SHAPE) + 1j * gen.normal(size=SHAPE)
                  ).astype(np.complex64)
        dat = os.path.join(root, "meas.dat")
        write_synthetic_twix(dat, kspace)
        img = v.process_RAW(dat)
        want = np.transpose(np.fft.fftshift(np.fft.fft2(np.fft.fftshift(
            kspace.astype(np.complex128), axes=(0, 1)), axes=(0, 1)),
            axes=(0, 1)), (1, 0, 2))[:, ::-1, :]
        twix_err = float(np.abs(img - want).max() / np.abs(want).max())
        checks["twix_recon_1e-5"] = twix_err < 1e-5 \
            and img.dtype == np.complex64
        rc, so, se = run_cli(["twix", "--dat", dat, "--out",
                              os.path.join(root, "twix")])
        checks["cli_twix"] = rc == 0 and np.array_equal(
            np.load(json.loads(so)["out"]), img)

        # the analyze and export commands on the card
        cli_out = os.path.join(root, "cli")
        paths = studies["typical"]
        rc, so, se = run_cli([
            "analyze", "--xenon", paths["xenon_path"], "--mask",
            paths["mask_path"], "--proton", paths["proton_path"], "--out",
            cli_out, "--npz", "--histogram"])
        if has_pil:
            got = json.loads(so) if rc == 0 else {}
            base = os.path.join(cli_out, "VENTJAX_PHANTOM")
            checks["cli_analyze"] = rc == 0 and all(
                abs(got[k] - v.metadata[k]) < 0.1
                for k in ("VDP", "VDP_lb", "VDP_km")) \
                and png_ok(base + ".png") and png_ok(base + "_hist.png")
            rc, so, se = run_cli(["export", "--npz-in", base + ".npz",
                                  "--out", os.path.join(root, "cli_export"),
                                  "--recalculate"])
            got = json.loads(so)["metrics"] if rc == 0 else {}
            checks["cli_export_recalculate"] = rc == 0 and all(
                abs(got[k] - v.metadata[k]) < 0.1
                for k in ("VDP", "VDP_lb", "VDP_km"))
        else:
            checks["cli_analyze_stops_without_pillow"] = rc == 2 \
                and "Pillow" in se and not os.path.exists(cli_out)
            log("facade: Pillow is absent here, so the PNG route of analyze "
                "and export was not exercised (the commands stop with exit 2)")
        launches = launch_counts()
        checks["kernels_launched"] = all(launches[k] > 0 for k in n4_path) \
            and launches["head_counts"] >= 2
        log(f"facade launches: {json.dumps(launches)}; N4 graphs: "
            f"{json.dumps(graph_counts())}")

        # outside the counted run: the kernels at path g's shapes, and the
        # facade against analyze_study on the same arrays, on the card
        errs, dvdp = {}, 0.0
        for name, f in facades.items():
            pad, retried, k_errs = check_facade_kernels(f, dev)
            for k, e in k_errs.items():
                errs.setdefault(k, []).extend(e)
            log(f"facade {name}: CI pad {pad}, tail_k retry ran: {retried}")
            if name == "severe":
                checks["severe_pad_ge_2048"] = pad >= 2048
            # the facade's pad, and its full-width tail (its retry)
            cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=pad,
                                         ci_tail_k=pad)
            res = analyze_study(
                torch.from_numpy(np.asarray(f.HPvent, np.float32)).to(dev),
                torch.from_numpy(np.asarray(f.mask, np.float32)).to(dev),
                build_geometry(VOX, SHAPE, cfg), cfg)
            for key, attr in (("VDP", "vdp"), ("VDP_lb", "vdp_lb"),
                              ("VDP_km", "vdp_km")):
                dvdp = max(dvdp, abs(f.metadata[key]
                                     - float(getattr(res.metrics, attr))))
            for attr, want in (("defectArray", res.defect),
                               ("defectArrayLB", res.defect_lb),
                               ("defectArrayKM", res.defect_km),
                               ("CIarray", res.ci_map)):
                checks[f"{name}_{attr}_equals_analyze_study"] = \
                    np.array_equal(getattr(f, attr), want.cpu().numpy())
        checks["dvdp_vs_analyze_study_lt_0.1"] = dvdp < 0.1
    checks = {k: bool(x) for k, x in checks.items()}
    log(f"facade checks: {json.dumps(checks)}; max |dVDP| vs analyze_study "
        f"{dvdp:.3e} pp; TWIX recon error {twix_err:.3e} of max |image|")
    if not all(checks.values()):
        raise AssertionError(f"the facade path failed: {checks}")
    log(f"time facade (host clock, ms per study): {json.dumps(times)}")
    return launches, times, {k: max(v) for k, v in errs.items()}


def check_facade_kernels(f, dev):
    """One facade study's kernels against their plain versions at the
    shapes the facade gives them: K1 and K2 at every ncp, K4 and K5 on the
    first and a late residual, on its N4 operands (N 1, P its lung's
    pad, config.n4_pad_for); K3 bit-equal on its defect coordinates at its
    CI pad (the shape of both of the facade's pairwise calls).  Returns the
    pad, whether the facade's first pairwise call overflowed (so that it
    retried at tail_k = pad), and the largest errors, as lists."""
    from ventjax_torch.compat import ci_module
    from ventjax_torch.config import n4_pad_for
    from ventjax_torch.ops import ci_cuda
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.pipeline import build_geometry

    hp = np.asarray(f.HPvent, np.float32)[None]
    mask = np.asarray(f.mask, np.float32)[None]
    n4_pad = n4_pad_for(f.config, int((mask > 0).sum()), hp[0].size)
    gen = np.random.default_rng(SEED + 302)
    errs = check_fit(hp, mask, n4_pad, dev, gen, freeze=False, k6_k7=False)
    errs.update(check_sharpen(hp, mask, n4_pad, dev))

    pad = ci_module.defect_pad(f.defectArray)
    geom = build_geometry(tuple(f.vox), f.defectArray.shape, f.config)
    if not isinstance(geom, tcp.CIPairwiseGeometry):
        raise AssertionError(f"the facade's geometry is not the pairwise "
                             f"engine's: {type(geom).__name__}")
    d = torch.from_numpy(f.defectArray.astype(np.float32))[None].to(dev)
    args = k3_args(tcp.defect_coords(d, pad)[0], geom)
    equal = bool(torch.equal(ci_cuda.head_counts(*args),
                             ci_cuda.head_counts_plain(*args)))
    log(f"K3 head_counts K={pad} N=1 (the facade's study): "
        f"bit_equal={equal}")
    if not equal:
        raise AssertionError(f"K3 differs from its plain version on the "
                             f"facade's study at K={pad}")
    errs["head_counts"] = [0.0]
    retried = bool(tcp.calculate_ci_pairwise(d, geom, pad)[2][0])
    return pad, retried, errs


# ---------------------------------------------------------------------------
# Path h: the segmentation model
# ---------------------------------------------------------------------------

SEG_HELDOUT = range(10_000, 10_024)   # tests/test_automask.py's seeds
SEG_OOF = range(24)
SEG_NEAR = 1e-3         # card and CPU masks may differ where |logit| < this
SEG_TRAIN_STEPS = 20
SEG_BATCH = 8           # train-seg's defaults: 8 x 16 slices of 128 x 128
SEG_STEP_ATOL = 1e-5    # parameters after one step, as the CPU tests hold


def dice(pred, true):
    return 2 * float((pred * true).sum()) / max(float(pred.sum()
                                                      + true.sum()), 1.0)


def seg_heldout(card, cpu, checks):
    """Held-out Dice on the card, each card mask against the port's CPU
    mask (voxels with a CPU |logit| < SEG_NEAR excepted and counted), and a
    repeat bit-identical.  Returns the Dice scores."""
    from ventjax_torch.io.phantom import make_random_phantom
    from ventjax_torch.models import segmentation as seg

    scores, near, near_differ, far_differ, repeat = [], 0, 0, 0, True
    for s in SEG_HELDOUT:
        ph = make_random_phantom(s)                  # random H, W and D too
        got = seg.predict_mask(card.model, ph.proton)
        repeat &= torch.equal(got, seg.predict_mask(card.model, ph.proton))
        logits = seg.predict_logits(cpu.model, ph.proton)
        differ = got.cpu() != (torch.sigmoid(logits) > 0.5).float()
        small = logits.abs() < SEG_NEAR
        near += int(small.sum())
        near_differ += int((differ & small).sum())
        far_differ += int((differ & ~small).sum())
        scores.append(dice(got.cpu().numpy(), ph.mask))
    log(f"segmentation: held-out Dice min {min(scores):.4f} mean "
        f"{statistics.mean(scores):.4f} over {len(scores)} studies; card vs "
        f"CPU masks: {far_differ} voxels differ where |logit| >= {SEG_NEAR}, "
        f"{near_differ} of the {near} voxels with |logit| < {SEG_NEAR}")
    checks["heldout_dice_each_ge_0.9"] = min(scores) >= 0.9
    checks["heldout_dice_mean_ge_0.93"] = statistics.mean(scores) >= 0.93
    checks["card_mask_equals_cpu"] = far_differ == 0
    checks["repeat_bit_identical"] = repeat
    return scores


def seg_qc(card, checks):
    """mask_qc passes a healthy prediction and flags the prediction on a
    pure-noise proton and tests/test_automask.py's four bad masks."""
    from ventjax_torch.io.phantom import make_random_phantom
    from ventjax_torch.models import segmentation as seg

    vox = VOX
    ph = make_random_phantom(10_050, shape=SHAPE)
    healthy = seg.mask_qc(seg.predict_mask(card.model, ph.proton), ph.vox)
    gen = np.random.default_rng(5)
    noise = gen.normal(500.0, 200.0, SHAPE).astype(np.float32)
    bad = {"noise_prediction": seg.predict_mask(card.model, noise),
           "speckle": (gen.random(SHAPE) < 0.05).astype(np.float32),
           "empty": np.zeros(SHAPE, np.float32)}
    bad["one_sided"] = np.zeros(SHAPE, np.float32)
    bad["one_sided"][30:90, 8:40, 4:12] = 1.0
    bad["clipped"] = np.zeros(SHAPE, np.float32)
    bad["clipped"][:, :30, :] = 1.0
    checks["qc_healthy_passes"] = not healthy["suspect"]
    for name, m in bad.items():
        checks[f"qc_flags_{name}"] = seg.mask_qc(m, vox)["suspect"]


def seg_train(dev, checks, times):
    """SEG_TRAIN_STEPS steps at train-seg's defaults on the card, the loss
    finite and falling; then one step on the card and on the CPU on the
    same batch, from the init and from the shipped parameters."""
    from ventjax_torch.io.phantom import make_random_cohort
    from ventjax_torch.models import segmentation as seg

    state = seg.create_train_state(torch.Generator().manual_seed(SEED),
                                   shape=SHAPE[:2], base=16,
                                   learning_rate=1e-3, device=dev)
    losses, step_ms = [], []
    for i in range(SEG_TRAIN_STEPS):
        _, mask, proton = make_random_cohort(
            SEG_BATCH, shape=SHAPE, seed=SEED + 1 + i * SEG_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(seg.train_step(state, proton, mask)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    times["train_step_ms"] = round(statistics.median(step_ms[1:]), 3)
    log(f"segmentation: {SEG_TRAIN_STEPS} train steps of {SEG_BATCH} x "
        f"{SHAPE[2]} slices, losses {[round(x, 4) for x in losses]}; step "
        f"ms (host clock, batch upload included) {times['train_step_ms']} "
        f"median, first {step_ms[0]:.1f}")
    checks["train_losses_finite"] = all(np.isfinite(losses))
    checks["train_loss_falls"] = losses[-1] < losses[0]

    # one step on the card and on the CPU on the same batch, from the same
    # parameters: flax's init (seed 0, the 20 steps' start), and the
    # shipped checkpoint, a converged model whose gradients are near Adam's
    # eps, where its first step lr * g / (|g| + eps) turns float32 gradient
    # differences into parameter differences up to ~lr: there the
    # gradients are held, as the CPU tests hold them to ventjax's
    _, mask, proton = make_random_cohort(SEG_BATCH, shape=SHAPE, seed=SEED)
    start = {"init": lambda d: seg.create_train_state(
        torch.Generator().manual_seed(SEED), shape=SHAPE[:2], base=16,
        learning_rate=1e-3, device=d)}
    start["shipped"] = lambda d: seg.load_checkpoint(
        seg.default_checkpoint_path(), device=d)
    for name, make in start.items():
        states = [make(dev), make("cpu")]
        for st in states:
            st.optimizer = seg._adam(st.model, 1e-3)
        loss = [float(seg.train_step(st, proton, mask)) for st in states]
        named = [dict(st.model.named_parameters()) for st in states]
        gmax = max(float(p.grad.abs().max()) for p in named[1].values())
        gerr = max(float((p.grad.cpu() - named[1][k].grad).abs().max())
                   for k, p in named[0].items()) / gmax
        perr = max(float((p.detach().cpu() - named[1][k].detach()).abs().max())
                   for k, p in named[0].items())
        lerr = abs(loss[0] - loss[1]) / abs(loss[1])
        log(f"segmentation: one step from the {name} parameters, card vs "
            f"CPU: loss {loss[0]:.7f} / {loss[1]:.7f} (relative "
            f"{lerr:.3e}), gradients max |d| {gerr:.3e} of max |g| "
            f"{gmax:.3e}, parameters after the step max |d| {perr:.3e}")
        checks[f"train_step_{name}_loss_equals_cpu"] = lerr <= 1e-5
        checks[f"train_step_{name}_grads_equal_cpu"] = gerr <= 1e-4
        if name == "init":
            checks["train_step_init_params_equal_cpu"] = perr <= SEG_STEP_ATOL
    return losses


def seg_cli(root, checks, times):
    """analyze --auto-mask on the card against the hand-mask run of the
    same study, its launches counted; then train-seg --steps 5 and analyze
    on that checkpoint.  Returns the counted run's launches."""
    import os

    from ventjax_torch.io.phantom import make_phantom
    from ventjax_torch.io.synthetic import write_study

    sdir = os.path.join(root, "seg_study")
    write_study(sdir, phantom=make_phantom(shape=SHAPE, vox=VOX, seed=77))
    base = ["analyze", "--xenon", f"{sdir}/xenon.dcm"]
    rc, so, se = run_cli(base + ["--mask", f"{sdir}/mask", "--out",
                                 os.path.join(root, "seg_hand")])
    hand = json.loads(so) if rc == 0 else {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rc, so, se = run_cli(base + ["--proton", f"{sdir}/proton.dcm",
                                 "--auto-mask", "--out",
                                 os.path.join(root, "seg_auto")])
    torch.cuda.synchronize()
    times["analyze_auto_mask_s"] = round(time.perf_counter() - t0, 3)
    launches = launch_counts()
    auto = json.loads(so) if rc == 0 else {}
    log(f"segmentation: analyze --auto-mask rc {rc} in "
        f"{times['analyze_auto_mask_s']} s: {json.dumps(auto)}; hand mask: "
        f"VDP {hand.get('VDP')} LungVolume {hand.get('LungVolume')}; "
        f"launches {json.dumps(launches)}{se and '; stderr: ' + se[-500:]}")
    checks["cli_auto_mask"] = rc == 0 and "automask_suspect" in auto \
        and bool(hand)
    if checks["cli_auto_mask"]:
        checks["auto_vdp_within_2pp"] = abs(auto["VDP"] - hand["VDP"]) < 2.0
        checks["auto_lung_volume_within_12pct"] = abs(
            auto["LungVolume"] - hand["LungVolume"]) \
            / hand["LungVolume"] < 0.12
    checks["auto_mask_kernels_launched"] = all(
        launches[k] > 0 for k in ("fit_moment", "fit_delta_conv_field",
                                  "sharpen_hist", "sharpen_resid",
                                  "head_counts"))

    ck = os.path.join(root, "seg_trained")
    rc, so, se = run_cli(["train-seg", "--steps", "5", "--out", ck])
    report = json.loads(so.splitlines()[-1]) if rc == 0 else {}
    checks["cli_train_seg"] = rc == 0 and os.path.isfile(
        report.get("checkpoint", ""))
    rc, so, se = run_cli(base + ["--proton", f"{sdir}/proton.dcm",
                                 "--auto-mask", "--seg-ckpt",
                                 report.get("checkpoint", ck), "--no-ci",
                                 "--out", os.path.join(root, "seg_own")])
    # five steps from flax's init may predict no lung at all; the command
    # then reads the checkpoint, predicts, and stops naming the empty mask
    checks["cli_analyze_trained_checkpoint"] = (
        rc == 0 and "automask_suspect" in json.loads(so)) or (
        rc == 2 and "predicted an empty lung mask" in se)
    log(f"segmentation: train-seg --steps 5 -> {json.dumps(report)}; "
        f"analyze on it rc {rc}{se and ': ' + se.strip()[-300:]}")
    return launches


def phase_segmentation(dev, card):
    """Path h: the segmentation model on the card (see the module
    docstring).  Returns the launches of analyze --auto-mask and the
    host-clock timings."""
    import tempfile

    from ventjax_torch.io.phantom import make_random_phantom
    from ventjax_torch.io.phantom_oof import make_oof_phantom
    from ventjax_torch.models import segmentation as seg

    t_path = time.perf_counter()
    checks, times = {}, {}
    path = seg.default_checkpoint_path()
    on_card = seg.load_checkpoint(path, device=dev)
    on_cpu = seg.load_checkpoint(path, device="cpu")
    checks["checkpoint_equals_cpu_load"] = on_card.step == on_cpu.step \
        == 800 and all(torch.equal(p.cpu(), on_cpu.params[k])
                       for k, p in on_card.params.items())
    scores = seg_heldout(on_card, on_cpu, checks)
    oof = [dice(seg.predict_mask(on_card.model, p).cpu().numpy(), m)
           for p, m, _ in (make_oof_phantom(s) for s in SEG_OOF)]
    log(f"segmentation: out-of-family Dice (information) min {min(oof):.4f} "
        f"mean {statistics.mean(oof):.4f} over {len(oof)} studies")
    seg_qc(on_card, checks)
    proton = torch.from_numpy(make_random_phantom(
        10_000, shape=SHAPE).proton).to(dev)
    times["predict_mask_ms"] = round(host_ms(
        lambda: seg.predict_mask(on_card.model, proton), reps=20)[0], 3)
    with tempfile.TemporaryDirectory() as root:
        launches = seg_cli(root, checks, times)
    seg_train(dev, checks, times)
    checks = {k: bool(x) for k, x in checks.items()}
    log(f"segmentation checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the segmentation path failed: {checks}")
    times["path_s"] = round(time.perf_counter() - t_path, 1)
    log(f"time segmentation (host clock; {card}): {json.dumps(times)}; "
        f"held-out Dice mean {statistics.mean(scores):.4f}")
    return launches, times


# ---------------------------------------------------------------------------
# Path i: dist/ (the slice-sharded halo CI, the batch mesh, the ranks)
# ---------------------------------------------------------------------------

OVERSIZE = (256, 256, 64)   # benchmarks/run.py config 7's oversize volume
OVERSIZE_K = 4096           # its per-shard center pad
OVERSIZE_SHARDS = 4
MESH_SHARDS = 4             # shards of the one card (a repeated device)


def make_severe_defects(batch, shape, vox, seed=11):
    """benchmarks/run.py's clustered severe-disease defect volumes, on the
    port's phantom: dense ellipsoids planted inside the phantom lungs until
    ~3.4-3.8k defect voxels per volume."""
    from ventjax_torch.io.phantom import make_phantom

    rng = np.random.default_rng(seed)
    defects = np.zeros((batch, *shape), np.float32)
    H, W, D = shape
    for b in range(batch):
        ph = make_phantom(shape=shape, vox=vox, seed=100 + b)
        m = np.asarray(ph.mask) > 0
        d = np.zeros(shape, np.float32)
        for _ in range(300):
            cc = np.array([rng.integers(H // 4, 3 * H // 4),
                           rng.integers(W // 4, 3 * W // 4),
                           rng.integers(3, max(4, D - 3))])
            rr = np.array([rng.integers(5, 12), rng.integers(5, 12),
                           rng.integers(2, 4)])
            ii, jj, kk = np.ogrid[:H, :W, :D]
            ell = (((ii - cc[0]) / rr[0]) ** 2 + ((jj - cc[1]) / rr[1]) ** 2
                   + ((kk - cc[2]) / rr[2]) ** 2) <= 1
            cand = d.copy()
            cand[ell & m] = 1
            if cand.sum() > 3800:
                continue
            d = cand
            if d.sum() > 3400:
                break
        defects[b] = d
    return defects


def capture_k3(fn):
    """(fn(), the arguments of every K3 call the CI engine made in it)."""
    from ventjax_torch.ops import ci_pairwise as tcp

    calls, real = [], tcp.head_counts

    def spy(*args):
        calls.append(args)
        return real(*args)

    tcp.head_counts = spy
    try:
        return fn(), calls
    finally:
        tcp.head_counts = real


def rank_main(port, rank, world, backend, data):
    """One rank of a torch.distributed group on the card.  Where
    data/job.json exists, path j's cohort driver (rank_cohort); else path
    i's halo CI of data/defect.npy, one shard per rank, its slab required
    bit-equal to the unsharded map data/ci.npy and the all-reduced
    saturated count to data/nsat.npy's.  Prints one RANK_OK line."""
    import os

    import torch.distributed as tdist

    if os.path.exists(os.path.join(data, "job.json")):
        return rank_cohort(port, int(rank), int(world), backend, data)
    if os.path.exists(os.path.join(data, "space.json")):
        return rank_space(port, int(rank), int(world), backend, data)

    from ventjax_torch.dist import (
        initialize_multihost, make_rank_mesh, make_sliced_ci_fn,
    )
    from ventjax_torch.ops import ci_cuda
    from ventjax_torch.ops.ci_pairwise import build_ci_pairwise_geometry

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke --rank: no CUDA card")
    rank, world = int(rank), int(world)
    t0 = time.perf_counter()
    initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    mesh = make_rank_mesh("cuda")
    defect = torch.from_numpy(np.load(f"{data}/defect.npy")).to(mesh.device)
    want = torch.from_numpy(np.load(f"{data}/ci.npy"))
    H, W, D = defect.shape
    dl = D // world
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 50, "wrap")
    fn = make_sliced_ci_fn(geom, mesh, max_defect_per_shard=OVERSIZE_K,
                           halo_pad=OVERSIZE_K // 2)
    ci, nsat, ovf = fn(defect[:, :, rank * dl:(rank + 1) * dl])
    out = {"rank": rank, "world": world, "backend": tdist.get_backend(),
           "device": str(ci.device),
           "bit_equal": bool(torch.equal(
               ci.cpu(), want[:, :, rank * dl:(rank + 1) * dl])),
           "nsat_equal": int(nsat) == int(np.load(f"{data}/nsat.npy")),
           "overflow": bool(ovf), "k3_launches": ci_cuda.LAUNCHES[
               "head_counts"], "s": round(time.perf_counter() - t0, 2)}
    tdist.destroy_process_group()
    print("RANK_OK " + json.dumps(out), flush=True)
    ok = out["bit_equal"] and out["nsat_equal"] and not out["overflow"] \
        and out["backend"] == backend and out["k3_launches"] > 0
    if not ok:
        raise AssertionError(f"rank {rank}: {out}")


def rank_cohort(port, rank, world, backend, data):
    """One rank of path j: run_cohort with use_mesh over a RankMesh of the
    group, once for each mode of data/job.json ("p0": process-0 export;
    "shard": shard_export; "lane": process-0 export at the job's batch
    size for that mode), each in its own counted window and followed by a
    call that must resume everything; prints one RANK_OK line with each
    mode's seconds, launch counts and resume counts.  A warm-up call on
    two studies, into its own directory, runs first."""
    import torch.distributed as tdist

    from ventjax_torch.dist import initialize_multihost
    from ventjax_torch.pipeline import cohort as tc

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke --rank: no CUDA card")
    with open(f"{data}/job.json") as f:
        job = json.load(f)
    initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    manifest = tc.load_manifest(job["manifest"])
    out = {"rank": rank, "world": world, "backend": tdist.get_backend(),
           "modes": {}}
    # a fresh process pays its first batch's one-time costs (libraries,
    # context, FFT plans) outside the timed modes, as path e's process has
    tc.run_cohort(manifest[:2], f"{data}/warm",
                  batch_size=job["batch"]["p0"], device="cuda",
                  use_mesh=True)
    for mode in job["modes"]:
        kw = dict(batch_size=job["batch"][mode], device="cuda",
                  use_mesh=True, shard_export=mode == "shard")
        tdist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = tc.run_cohort(manifest, job["out"][mode], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        reset_counts()
        again = tc.run_cohort(manifest, job["out"][mode], **kw)
        out["modes"][mode] = {
            "s": round(wall, 3), "launches": launches,
            "resume_launches": launch_counts(), "results": len(results),
            "valid": sum(1 for r in results if r.get("valid")),
            "resumed": len(again)}
    tdist.destroy_process_group()
    print("RANK_OK " + json.dumps(out), flush=True)


def start_ranks(world, backend, data):
    """world processes of this script in --rank mode on a free port."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(port), str(r), str(world),
         backend, data], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def finish_ranks(procs, timeout=240):
    """Each rank's RANK_OK record; raises, after killing what still runs,
    when a rank fails or outlasts the timeout."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for p, out in zip(procs, outs):
        line = [x for x in out.splitlines() if x.startswith("RANK_OK ")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"a rank failed (exit {p.returncode}):\n"
                                 f"{out[-3000:]}")
        recs.append(json.loads(line[0][len("RANK_OK "):]))
    return recs


def first_difference(got, want):
    """{field: max |difference|} of the VentResult fields (metrics too)
    whose bits differ (NaN equal to NaN)."""
    import dataclasses

    from ventjax_torch.pipeline.result import StudyMetrics

    pairs = {f: (getattr(got, f), getattr(want, f)) for f in (
        "n4", "defect", "defect_lb", "defect_km", "defect_border", "ci_map")}
    pairs.update({f"metrics.{f}": (getattr(got.metrics, f),
                                   getattr(want.metrics, f))
                  for f in (x.name for x in dataclasses.fields(
                      StudyMetrics))})
    diff = {}
    for name, (a, b) in pairs.items():
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        if not bool(same.all()):
            diff[name] = float((a - b)[~same].abs().nan_to_num(
                float("inf")).max())
    return diff


def phase_dist(dev, cfg, geom, hp_d, mask_d, res):
    """Path i: dist/ on the card (see the module docstring).  Returns its
    launch counts (summed over its entries, and by entry), host-clock
    timings and K3's per-shard record."""
    import importlib.util
    import os
    import tempfile

    from ventjax_torch.compat import Vent_Analysis, ci_module
    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.dist import halo
    from ventjax_torch.dist import mesh as dmesh
    from ventjax_torch.ops import ci_cuda
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.pipeline import analyze_cohort, build_geometry
    from ventjax_torch.pipeline import cohort as tc

    t_path = time.perf_counter()
    checks, times = {}, {}
    defect = torch.from_numpy(make_severe_defects(1, OVERSIZE, VOX)[0]).to(
        dev)
    ogeom = tcp.build_ci_pairwise_geometry(VOX, OVERSIZE, 50, "wrap")
    log(f"dist: oversize {OVERSIZE}, {int(defect.sum())} defect voxels, "
        f"halo {halo.halo_width(ogeom)} slices, made in "
        f"{time.perf_counter() - t_path:.1f} s")

    def sharded(n=OVERSIZE_SHARDS):
        return halo.calculate_ci_sharded(defect, ogeom, n_shards=n,
                                         max_defect_voxels=OVERSIZE_K)

    def unsharded():
        return tcp.calculate_ci_pairwise(defect[None], ogeom, OVERSIZE_K)

    has_pil = importlib.util.find_spec("PIL") is not None
    real_devices = dmesh.local_devices
    dmesh.local_devices = lambda device="cuda": [dev] * MESH_SHARDS
    by_entry = {}

    def counted(name, fn):
        """fn() with the launch counts set to 0 just before and read just
        after, under name; the references run outside these windows."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_entry[name] = launch_counts()
        return out

    try:
        with tempfile.TemporaryDirectory() as root:
            studies = facade_studies(root)                # path g's
            manifest = write_cohort(os.path.join(root, "cohort"))  # path e's
            severe = studies["severe"]
            argv = ["analyze", "--xenon", severe["xenon_path"], "--mask",
                    severe["mask_path"], "--proton", severe["proton_path"]]
            out_m, out_p = (os.path.join(root, x) for x in ("mesh", "plain"))

            # the references, uncounted: the unsharded oversize map, path
            # g's severe study's VDP and its exact map, the cohort without
            # the mesh, and the plain analyze command
            ci_u, nsat_u, ovf_u = unsharded()
            v = Vent_Analysis(**severe, config=DEFAULT_CONFIG.replace(
                ci_shard_slices=2))
            v.calculate_VDP()
            pad = ci_module.defect_pad(v.defectArray)
            d = torch.from_numpy(v.defectArray.astype(np.float32)).to(dev)
            sgeom = build_geometry(tuple(v.vox), tuple(d.shape), v.config)
            exact = tcp.calculate_ci_pairwise(d[None], sgeom, pad,
                                              tail_k=pad)[0][0]
            tc.run_cohort(manifest, out_p, batch_size=COHORT_BATCH,
                          device=dev)
            rc1, so1, _ = run_cli(argv + ["--out", os.path.join(root, "a1")])
            log(f"dist: severe study, {int(v.defectArray.sum())} defect "
                f"voxels at pad {pad}")

            # each dist entry in its own counted window
            # the oversize volume over four shards of the card
            ci_s, nsat_s, ovf_s = counted("oversize_4_shards", sharded)
            checks["oversize_bit_equal"] = torch.equal(ci_s, ci_u[0])
            checks["oversize_nsat_equal"] = int(nsat_s) == int(nsat_u[0])
            checks["oversize_no_overflow"] = not (bool(ovf_s)
                                                  or bool(ovf_u[0]))

            # path g's severe study: two shards of its defect map, and the
            # facade's calculate_CI with ci_shard_slices 2
            two = counted("severe_2_shards", lambda: halo.calculate_ci_sharded(
                d, sgeom, n_shards=2, max_defect_voxels=pad, tail_k=pad,
                halo_pad=pad))
            checks["severe_two_shards_bit_equal"] = torch.equal(
                two[0], exact) and not bool(two[2])
            counted("facade_shard_slices_2", v.calculate_CI)
            checks["facade_shard_slices_2_equal"] = np.array_equal(
                v.CIarray, exact.cpu().numpy().astype(np.float64))

            # the slice through a batch mesh of four shards, against path a
            mesh4 = dmesh.make_batch_mesh()
            by_mesh = dmesh.shard_cohort_fn(
                lambda h, m: analyze_cohort(h, m, geom, cfg), mesh4)
            diff = first_difference(
                counted("slice_mesh", lambda: by_mesh(hp_d, mask_d)), res)
            checks["mesh_bit_identical_to_path_a"] = not diff
            log(f"dist: the slice over {mesh4.size} shards against one batch "
                f"of {BATCH}: differing fields {json.dumps(diff)}")

            # the cohort driver with use_mesh over four shards, against one
            runners = {}
            counted("cohort_use_mesh", lambda: tc.run_cohort(
                manifest, out_m, batch_size=COHORT_BATCH, runners=runners,
                device=dev, use_mesh=True))
            (runner,) = runners.values()
            checks["cohort_on_the_mesh"] = runner.mesh is not None \
                and runner.mesh.size == MESH_SHARDS
            same = True
            for e in manifest:
                sid = e["id"]
                for f in ("metrics.json", f"{sid}_dataArray.nii", ".done"):
                    a, b = (os.path.join(o, sid, f) for o in (out_m, out_p))
                    if os.path.exists(a) or os.path.exists(b):
                        same &= os.path.exists(a) and os.path.exists(b) \
                            and open(a, "rb").read() == open(b, "rb").read()
            checks["cohort_mesh_exports_equal"] = same

            # analyze --shard-slices 2 against analyze on the severe study
            rc2, so2, se2 = counted("cli_shard_slices_2", lambda: run_cli(
                argv + ["--out", os.path.join(root, "a2"), "--shard-slices",
                        "2"]))
            checks["cli_shard_slices_2"] = (
                rc1 == rc2 == 0 and json.loads(so1) == json.loads(so2)
            ) if has_pil else rc1 == rc2 == 2
            log(f"dist launches by entry: {json.dumps(by_entry)}")

            # K3 once per shard where the entry runs CI once; N4's kernels
            # wherever the entry runs N4; no entry may pass without them
            n4_keys = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
                       "sharpen_resid")
            k3_by = {k: c["head_counts"] for k, c in by_entry.items()}
            checks["k3_once_a_shard"] = (
                k3_by["oversize_4_shards"] == OVERSIZE_SHARDS
                and k3_by["severe_2_shards"] == 2
                and k3_by["slice_mesh"] == MESH_SHARDS)
            checks["k3_in_every_entry"] = all(
                n >= 2 for k, n in k3_by.items()
                if k != "cli_shard_slices_2" or has_pil)
            checks["n4_kernels_in_the_mesh_entries"] = all(
                by_entry[e][k] > 0 for e in ("slice_mesh", "cohort_use_mesh")
                + (("cli_shard_slices_2",) if has_pil else ())
                for k in n4_keys)
            launches = {k: sum(c[k] for c in by_entry.values())
                        for k in launch_counts()}
            log(f"dist launches: {json.dumps(launches)}")

            # ranks: two under gloo on the one card, and NCCL at one rank
            # per card, all at once
            data = os.path.join(root, "ranks")
            os.makedirs(data)
            np.save(os.path.join(data, "defect.npy"), defect.cpu().numpy())
            np.save(os.path.join(data, "ci.npy"), ci_u[0].cpu().numpy())
            np.save(os.path.join(data, "nsat.npy"), int(nsat_u[0]))
            t = time.perf_counter()
            gloo = start_ranks(2, "gloo", data)
            nccl = start_ranks(torch.cuda.device_count(), "nccl", data)
            recs = finish_ranks(gloo) + finish_ranks(nccl)
            times["ranks_s"] = round(time.perf_counter() - t, 1)
            log(f"dist ranks: {json.dumps(recs)}; a two-rank NCCL run needs "
                f"two cards (NCCL refuses two ranks on one card)")
            checks["gloo_two_ranks_one_card"] = [
                (r["backend"], r["world"]) for r in recs[:2]] == [
                ("gloo", 2)] * 2
            checks["nccl_one_rank_per_card"] = all(
                r["backend"] == "nccl" for r in recs[2:]) \
                and len(recs) == 2 + torch.cuda.device_count()

            # outside the counted windows: K3 on each shard's own arguments
            # (centers, local + halo witnesses) against its plain version
            _, calls_s = capture_k3(sharded)
            _, calls_u = capture_k3(unsharded)
            equal = [bool(torch.equal(ci_cuda.head_counts(*a),
                                      ci_cuda.head_counts_plain(*a)))
                     for a in calls_s + calls_u]
            widths = [a[1][0].shape[1] for a in calls_s]
            checks["k3_shards_bit_equal_to_plain"] = all(equal)
            checks["k3_interior_kw_2k"] = widths[1] == 2 * OVERSIZE_K
            log(f"dist: K3 per shard bit-equal to its plain version: {equal}"
                f" (witness lanes {widths})")
            interior, whole = calls_s[1], calls_u[0]
            ns = interior[2].shape[0]
            # centers and witnesses in (3 int32 each), counts out
            b3 = bound(OVERSIZE_K * (3 * 4 + ns * 4) + widths[1] * 3 * 4,
                       8 * k3_box_distances(*interior))
            k3 = {"K": OVERSIZE_K, "Kw": widths[1],
                  "ms": device_ms(lambda: ci_cuda.head_counts(*interior)),
                  "plain_ms": device_ms(lambda: ci_cuda.head_counts_plain(
                      *interior), reps=3),
                  "unsharded_ms": device_ms(
                      lambda: ci_cuda.head_counts(*whole)),
                  "bound_ms": b3[0], "bound_by": b3[1]}
            times["ci_sharded_ms"] = round(host_ms(sharded)[0], 3)
            times["ci_unsharded_ms"] = round(host_ms(unsharded)[0], 3)
            times["slice_mesh_ms"] = round(host_ms(
                lambda: by_mesh(hp_d, mask_d), reps=3)[0], 3)
            times["slice_batch_ms"] = round(host_ms(
                lambda: analyze_cohort(hp_d, mask_d, geom, cfg),
                reps=3)[0], 3)
    finally:
        dmesh.local_devices = real_devices
    checks = {k: bool(x) for k, x in checks.items()}
    log(f"dist checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the dist path failed: {checks}")
    times["path_s"] = round(time.perf_counter() - t_path, 1)
    log(f"time dist (host clock): {json.dumps(times)}; K3 per shard "
        f"{json.dumps(k3)}")
    return launches, by_entry, times, k3


# ---------------------------------------------------------------------------
# Path j: the multi-process cohort driver; path k: the GUI controller
# ---------------------------------------------------------------------------

PATH_KERNELS = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
                "sharpen_resid", "head_counts", "n4_field")


def exports_equal(out, ref, manifest, stamped):
    """Every file of each subject in out byte-equal to ref's (metrics.json
    equal but for the export_process stamp where stamped), and the ranks
    that stamped them."""
    import os

    same, ranks = True, set()
    for e in manifest:
        sid = e["id"]
        for f in (".done", "metrics.json", f"{sid}_dataArray.nii",
                  f"{sid}.json"):
            a, b = (os.path.join(o, sid, f) for o in (out, ref))
            if not (os.path.exists(a) or os.path.exists(b)):
                continue
            if not (os.path.exists(a) and os.path.exists(b)):
                return False, ranks
            da, db = open(a, "rb").read(), open(b, "rb").read()
            if f == "metrics.json" and stamped:
                ma, mb = json.loads(da), json.loads(db)
                if "export_process" in ma:
                    ranks.add(ma.pop("export_process"))
                same &= json.dumps(ma, sort_keys=True) == json.dumps(
                    mb, sort_keys=True)
            else:
                same &= da == db
    return same, ranks


def phase_multiproc(dev):
    """Path j: run_cohort with use_mesh over a RankMesh of two gloo ranks
    of this script sharing the card (--rank with a job), on path e's 32
    studies, with process-0 export and with shard_export at path e's batch
    of 16 (8 lanes a rank), and with process-0 export at a batch of 2 (one
    lane a rank: the dense field of a one-lane shard); then one NCCL rank
    per card with process-0 export.  Every export byte-equal to the
    one-process run at the same batch size (path e's run at 16;
    metrics.json but for the rank stamp of shard_export), every rank
    launching K1, K2, K4, K5, K3 and the dense-field kernel in each mode's
    own window, the shard run's files written by both ranks, each second
    call resuming everything without a launch.  Returns subjects/s per
    mode and the launch counts summed over ranks and modes."""
    import os
    import tempfile

    from ventjax_torch.pipeline import cohort as tc

    t_path = time.perf_counter()
    checks, rates = {}, {}
    with tempfile.TemporaryDirectory() as root:
        manifest = write_cohort(os.path.join(root, "cohort"))
        mpath = os.path.join(root, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        batch = {"p0": COHORT_BATCH, "shard": COHORT_BATCH, "lane": 2}
        refs = {}
        for bs in sorted(set(batch.values()), reverse=True):
            refs[bs] = os.path.join(root, f"one_bs{bs}")
            t0 = time.perf_counter()
            tc.run_cohort(manifest, refs[bs], batch_size=bs, device=dev)
            rates[f"one_process_bs{bs}"] = COHORT_STUDIES / (
                time.perf_counter() - t0)

        def job(name, modes):
            data = os.path.join(root, name)
            os.makedirs(data)
            with open(os.path.join(data, "job.json"), "w") as f:
                json.dump({"manifest": mpath, "modes": modes, "batch": batch,
                           "out": {m: os.path.join(root, f"{name}_{m}")
                                   for m in modes}}, f)
            return data

        gloo = finish_ranks(start_ranks(2, "gloo", job("gloo", [
            "p0", "shard", "lane"])), timeout=480)
        nccl = finish_ranks(start_ranks(torch.cuda.device_count(), "nccl",
                                        job("nccl", ["p0"])), timeout=480)
        log("multiproc ranks: " + json.dumps(gloo + nccl))
        checks["gloo_two_ranks"] = [(r["backend"], r["world"])
                                    for r in gloo] == [("gloo", 2)] * 2
        checks["nccl_one_rank_per_card"] = all(
            r["backend"] == "nccl" for r in nccl) \
            and len(nccl) == torch.cuda.device_count()
        launches = {}
        for tag, recs in (("gloo", gloo), ("nccl", nccl)):
            for r in recs:
                for mode, m in r["modes"].items():
                    key = f"{tag}_{mode}_rank{r['rank']}"
                    checks[f"{key}_kernels"] = all(
                        m["launches"][k] > 0 for k in PATH_KERNELS)
                    checks[f"{key}_resume_no_launch"] = not any(
                        m["resume_launches"].values())
                    checks[f"{key}_subjects"] = (
                        m["results"] == m["resumed"] == len(manifest)
                        and m["valid"] == COHORT_STUDIES)
                    for k, v in m["launches"].items():
                        launches[k] = launches.get(k, 0) + v
            for mode in recs[0]["modes"]:
                same, ranks = exports_equal(
                    os.path.join(root, f"{tag}_{mode}"), refs[batch[mode]],
                    manifest, stamped=mode == "shard")
                checks[f"{tag}_{mode}_exports_equal_one_process"] = same
                if mode == "shard":
                    checks["shard_files_from_both_ranks"] = ranks == {0, 1}
                else:
                    checks[f"{tag}_{mode}_unstamped"] = not ranks
                rates[f"{tag}_{mode}"] = COHORT_STUDIES / recs[0]["modes"][
                    mode]["s"]
    checks = {k: bool(v) for k, v in checks.items()}
    log(f"multiproc checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the multi-process path failed: {checks}")
    log(f"time multiproc (host clock): subjects/s "
        f"{json.dumps({k: round(v, 3) for k, v in rates.items()})}; path "
        f"{time.perf_counter() - t_path:.1f} s; launches (both ranks, both "
        f"modes) {json.dumps(launches)}")
    return rates, launches


def phase_gui(dev):
    """Path k: the GUI controller headless on the card (its default
    device): load, calculate VDP, calculate CI and export on path g's
    typical study, in one counted window; the statuses, colours and button
    states tests/test_gui.py expects; the kernels of the path launched;
    VDPs within 0.1 pp of Vent_Analysis on the same study and its CI map
    equal; the export's files (the PNG needs Pillow: without it the export
    must fail red, as the reference's controller does)."""
    import importlib.util
    import os
    import tempfile

    from ventjax_torch.compat import Vent_Analysis
    from ventjax_torch.gui.controller import DONE, GuiState, VentController

    has_pil = importlib.util.find_spec("PIL") is not None
    checks = {}
    with tempfile.TemporaryDirectory() as root:
        typ = facade_studies(root)["typical"]
        ref = Vent_Analysis(**typ)
        ref.calculate_VDP()
        ref.calculate_CI()
        out = os.path.join(root, "gui_out")
        c = VentController(GuiState(
            dicom_path=typ["xenon_path"], mask_path=typ["mask_path"],
            proton_path=typ["proton_path"], export_path=out, user="RPT"))
        seen = []
        c.on_status = lambda st: seen.append((st.text, st.color))
        steps = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for name, fn in (("load", c.load_from_paths),
                         ("vdp", c.calculate_vdp), ("ci", c.calculate_ci)):
            steps.append((name, fn(), c.status.text, c.status.color))
        c.select_irb("mepo")
        c.state.mepo_id, c.state.mepo_visit = "0039", "2"
        c.state.mepo_treatment = "preAlb"
        steps.append(("export", c.export(today="250101"), c.status.text,
                      c.status.color))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        want = [("load", True, "Vent_Analysis loaded", "green"),
                ("vdp", True, "VDP Calculated", "green"),
                ("ci", True, "CI Calculated successfully", "green")]
        checks["statuses"] = steps[:3] == want
        if has_pil:
            checks["export_status"] = steps[3] == (
                "export", True, "Data Successfully Exported but not "
                "Archived...", "orange")
        else:
            checks["export_status"] = not steps[3][1] and steps[3][2] \
                .startswith("ERROR: export failed") and steps[3][3] == "red"
        checks["in_progress_blue"] = all(x in seen for x in (
            ("Calculating VDP...", "blue"), ("Calculating CI...", "blue"),
            ("Exporting Data...", "blue")))
        checks["buttons"] = all(c.buttons[b] == DONE for b in (
            "initialize", "calcvdp", "calcci")) and (
            c.buttons["export"] == DONE) == has_pil
        checks["on_the_card"] = c.study.device.type == "cuda"
        checks["kernels"] = all(launches[k] > 0 for k in PATH_KERNELS)
        dvdp = max(abs(float(c.study.metadata[k]) - float(ref.metadata[k]))
                   for k in ("VDP", "VDP_lb", "VDP_km"))
        checks["vdp_within_0.1pp"] = dvdp < 0.1
        checks["ci_map_equal"] = np.array_equal(c.study.CIarray,
                                                ref.CIarray)
        if has_pil:
            base = c.study.metadata["fileName"]
            exp = os.path.join(out, "VentAnalysis_RPT_250101")
            files = set(os.listdir(exp))
            checks["export_files"] = base.startswith("Mepo0039_") \
                and base.endswith("_visit2_preAlb") and {
                    f"{base}.json", f"{base}.pkl", f"{base}.png",
                    f"{base}_dataArray.nii", "defectDICOMS"} <= files
        log(f"gui steps: {json.dumps(steps)}; launches {json.dumps(launches)}"
            f"; max |dVDP| {dvdp:.3e} pp against Vent_Analysis; "
            f"{wall:.2f} s for the four events (host clock)")
    checks = {k: bool(v) for k, v in checks.items()}
    log(f"gui checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the GUI path failed: {checks}")
    return launches, wall


# ---------------------------------------------------------------------------
# Path l: the space axis (the ("batch", "space") mesh on the card)
# ---------------------------------------------------------------------------

SPACE_MESH = (4, 4)            # the headline: 16 shards, 32 rows a slab
SPACE_OVERSIZE_MESH = (1, 4)   # path i's oversize geometry as one study
SPACE_TRAIN_MESH = (2, 4)      # the train step: 4 lanes a row, 32-row slabs
SPACE_TRAIN_STEPS = 3
# the wrappers of path l's kernels, with the kernel record each launches
SPACE_KERNELS = {"fit_moment_partial": "fit_moment",
                 "fit_delta_conv_field": "fit_delta_conv_field",
                 "sharpen_hist_partial": "sharpen_hist",
                 "sharpen_resid": "sharpen_resid",
                 "n4_field": "n4_field", "head_counts": "head_counts"}
# the split entry points (one reduce, fold and finish per N4 step)
SPACE_ENTRIES = ("fit_moment_partial", "fit_moment_reduce", "fit_fold_stats",
                 "sharpen_hist_partial", "sharpen_hist_finish")


def profiled_run(fn):
    """(fn(), device ms of its activities, activity count): one call under
    torch.profiler, after spin kernels that take the activities a session
    can lose first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(24):
            torch.cuda._sleep(100)
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in device_events(prof) if "spin_kernel" not in e.name]
    return out, sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)


def capture_space(fn):
    """(fn(), the arguments of the first call of each of path l's kernel
    wrappers in it): the slab-shaped operands, for the plain checks."""
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.ops import n4_space

    seen, undo = {}, []
    for mod, name in ((n4_space, "fit_moment_partial"),
                      (n4_space, "fit_delta_conv_field"),
                      (n4_space, "sharpen_hist_partial"),
                      (n4_space, "sharpen_resid"), (n4_space, "n4_field"),
                      (tcp, "head_counts")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.setdefault(_name, (a, kw))
            return _real(*a, **kw)

        setattr(mod, name, spy)
        undo.append((mod, name, real))
    try:
        return fn(), seen
    finally:
        for mod, name, real in undo:
            setattr(mod, name, real)


def check_space_kernels(seen):
    """Every kernel of path l on its slab operands against its plain
    version, and each split entry point against its plain version and the
    one-call entry point.  Returns (checks, max error per kernel record,
    K2's error by output)."""
    from ventjax_torch.ops import ci_cuda, n4_cuda, n4_field_cuda
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    checks, err = {}, {}
    cpu = lambda ts: [t.cpu() if isinstance(t, torch.Tensor) else t
                      for t in ts]
    a, _ = seen["fit_moment_partial"]
    part = n4_cuda.fit_moment_partial(*a)
    err["fit_moment"] = scaled_err(part.cpu(),
                                   n4_cuda.fit_moment_partial_plain(*cpu(a)))
    checks["k1_partial_plain"] = err["fit_moment"] <= KERNEL_RTOL
    red = n4_cuda.fit_moment_reduce(part)
    checks["k1_reduce_plain_bit_equal"] = torch.equal(
        red.cpu(), n4_cuda.fit_moment_reduce_plain(part.cpu()))
    checks["k1_split_equals_one_call"] = torch.equal(
        red, n4_cuda.fit_moment(*a))
    a, kw = seen["fit_delta_conv_field"]
    got = n4_cuda.fit_delta_conv_field(*a, **kw)
    want = n4_cuda.fit_delta_conv_field_plain(*cpu(a), **kw)
    e2 = k2_errors([g.cpu() for g in got[:3]], want, cpu(a))
    err["fit_delta_conv_field"] = max(e2.values())
    checks["k2_plain"] = err["fit_delta_conv_field"] <= KERNEL_RTOL
    fold = n4_cuda.fit_fold_stats(got[3])
    checks["k2_fold_equals_one_call"] = torch.equal(fold, got[2])
    checks["k2_fold_plain_bit_equal"] = torch.equal(
        fold.cpu(), n4_cuda.fit_fold_stats_plain(got[3].cpu()))
    a, _ = seen["sharpen_hist_partial"]
    hp = sc.sharpen_hist_partial(*a)
    checks["k4_partial_fixed_plain_bit_equal"] = torch.equal(
        hp.cpu(), sc.sharpen_hist_partial_plain(*cpu(a)))
    hist = sc.sharpen_hist_finish(hp, a[-1])
    checks["k4_finish_plain_bit_equal"] = torch.equal(
        hist.cpu(), sc.sharpen_hist_finish_plain(hp.cpu(), a[-1]))
    checks["k4_split_equals_one_call"] = torch.equal(hist,
                                                     sc.sharpen_hist(*a))
    err["sharpen_hist"] = scaled_err(hist.cpu(),
                                     sc.sharpen_hist_plain(*cpu(a)))
    a, _ = seen["sharpen_resid"]
    r5 = sc.sharpen_resid(*a)
    checks["k5_plain_bit_equal"] = torch.equal(
        r5.cpu(), sc.sharpen_resid_plain(*cpu(a)))
    err["sharpen_resid"] = scaled_err(r5.cpu(),
                                      sc.sharpen_resid_plain(*cpu(a)))
    a, kw = seen["n4_field"]
    f = n4_field_cuda.n4_field(*a, **kw)
    checks["field_rows_plain_bit_equal"] = torch.equal(
        f.cpu(), n4_field_cuda.n4_field_plain(*cpu(a), **kw))
    r0, r1 = kw["rows"]
    checks["field_rows_equal_full_field"] = torch.equal(
        f, n4_field_cuda.n4_field(*a)[:, r0:r1])
    err["n4_field"] = scaled_err(f.cpu(), n4_field_cuda.n4_field_plain(
        *cpu(a), **kw))
    if "head_counts" in seen:   # over ranks, the row's first rank's only
        a, _ = seen["head_counts"]
        checks["k3_plain_bit_equal"] = torch.equal(
            ci_cuda.head_counts(*a), ci_cuda.head_counts_plain(*a))
        err["head_counts"] = 0.0
    shape = lambda name: list(seen[name][0][1].shape)
    log(f"space: kernels at slab shapes (K1 rows {shape('fit_moment_partial')}"
        f", K2 rows {shape('fit_delta_conv_field')}, field rows {r1 - r0}): "
        f"errors {json.dumps(err)}; K2 by output {json.dumps(e2)}")
    return checks, err, e2


def k2_errors(got, want, args):
    """K2's outputs (field', logu', stats) against its plain version's by
    check_fit's measures: field' and logu' relative to their largest
    magnitude; s1, which sums terms of both signs, relative to the summed
    magnitude of its terms; s2 relative to itself; min and max relative
    to their span.  ``args`` are K2's host operands (phi, the three rows,
    wv, field, logv, done)."""
    from ventjax_torch.ops import n4_cuda

    wv, field = args[4], args[5]
    free = n4_cuda.fit_delta_conv_field_plain(
        *args[:7], torch.zeros_like(args[7]))[0]
    s_scale = (wv * torch.expm1(field - free)).abs().sum(1)
    span = want[2][:, 3] - want[2][:, 2]
    rel = lambda i, scale: float(((got[2][:, i] - want[2][:, i]).abs()
                                  / scale).max())
    return {"field": scaled_err(got[0], want[0]),
            "logu": scaled_err(got[1], want[1]),
            "s1": rel(0, s_scale), "s2": rel(1, want[2][:, 1].abs()),
            "min": rel(2, span), "max": rel(3, span)}


def space_required(counts, n_batch, n_space):
    """The counted window's launches meet path l's rule: K1, K2, K4 and K5
    at least once a slab (a whole number of times per batch row's slabs),
    the dense field once a slab, K3 once a batch row."""
    shards = n_batch * n_space
    n4 = ("fit_moment_partial", "fit_delta_conv_field",
          "sharpen_hist_partial", "sharpen_resid")
    return (all(counts[k] >= shards and counts[k] % n_space == 0
                for k in n4)
            and counts["n4_field"] == shards
            and counts["head_counts"] == n_batch)


def space_compare(got, want, tag, checks):
    """Path l's checks of a spatial run against the unsharded one; returns
    the N4 image's max |difference|."""
    equal = lambda f: torch.equal(getattr(got, f), getattr(want, f))
    for f in ("defect", "defect_lb", "defect_km", "ci_map"):
        checks[f"{tag}_{f}_equal"] = equal(f)
    g, w = got.metrics, want.metrics
    checks[f"{tag}_snr_bit_equal"] = torch.equal(g.snr.isnan(),
                                                 w.snr.isnan()) and bool(
        (g.snr == w.snr)[~w.snr.isnan()].all())
    for f in ("lung_volume", "ci_saturated", "ci_overflow", "n4_overflow",
              "valid"):
        checks[f"{tag}_{f}_equal"] = torch.equal(getattr(g, f),
                                                 getattr(w, f))
    n4_dev = float((got.n4 - want.n4).abs().max())
    dv = max(float((getattr(g, f) - getattr(w, f)).abs().max())
             for f in ("vdp", "vdp_lb", "vdp_km"))
    checks[f"{tag}_vdp_within_0.1pp"] = dv < 0.1
    if n4_dev == 0.0:
        checks[f"{tag}_vdp_equal_where_n4_bit_equal"] = all(
            torch.equal(getattr(g, f), getattr(w, f))
            for f in ("vdp", "vdp_lb", "vdp_km", "ci"))
    log(f"space {tag}: N4 image max |d| {n4_dev!r}, VDPs max |d| {dv!r} pp")
    return n4_dev


def phase_space(dev, cfg, geom, hp_d, mask_d, res):
    """Path l: the space axis on the card (see the module docstring).
    Returns (launches per kernel record, launches by entry point, max
    errors, timings)."""
    import functools

    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.dist import make_batch_space_mesh, spatial_shard_fn
    from ventjax_torch.io.phantom import make_cohort, make_random_cohort
    from ventjax_torch.models import segmentation as seg
    from ventjax_torch.ops import n4
    from ventjax_torch.ops.basic import sort_compact_masked
    from ventjax_torch.ops.n4_space import n4_slabs
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    t_path = time.perf_counter()
    checks, times, counts = {}, {}, {}

    # 1. the headline batch over a 4 x 4 mesh of the card, against path a's
    #    analyze_cohort of the same batch (res, same cfg)
    nb, ns = SPACE_MESH
    mesh = make_batch_space_mesh(nb, ns, devices=[dev] * (nb * ns))
    fn = spatial_shard_fn(functools.partial(analyze_cohort, geom=geom,
                                            config=cfg), mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = fn(hp_d, mask_d)
    torch.cuda.synchronize()
    times["headline_host_ms"] = (time.perf_counter() - t0) * 1e3
    counts["headline"] = launch_counts()
    syncs = n4.HOST_SYNCS["n4"]
    checks["headline_kernels"] = space_required(counts["headline"], nb, ns)
    log(f"space headline {nb}x{ns}: launches "
        f"{json.dumps(counts['headline'])}; N4 host syncs {syncs}")
    n4_dev = space_compare(got, res, "headline", checks)
    (again, seen), times["headline_device_ms"], acts = profiled_run(
        lambda: capture_space(lambda: fn(hp_d, mask_d)))
    checks["headline_repeat_bit_identical"] = all(
        torch.equal(getattr(got, f), getattr(again, f))
        for f in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
                  "ci_map")) and all(
        torch.equal(getattr(got.metrics, f).nan_to_num(),
                    getattr(again.metrics, f).nan_to_num())
        for f in ("snr", "vdp", "vdp_lb", "vdp_km", "ci", "ci_saturated"))
    t0 = time.perf_counter()
    analyze_cohort(hp_d, mask_d, geom, cfg)
    torch.cuda.synchronize()
    times["unsharded_host_ms"] = (time.perf_counter() - t0) * 1e3
    _, times["unsharded_device_ms"], acts_u = profiled_run(
        lambda: analyze_cohort(hp_d, mask_d, geom, cfg))
    log(f"space headline: host ms {times['headline_host_ms']!r} (unsharded "
        f"{times['unsharded_host_ms']!r}), device ms "
        f"{times['headline_device_ms']!r} in {acts} activities (unsharded "
        f"{times['unsharded_device_ms']!r} in {acts_u})")
    kchecks, err, _ = check_space_kernels(seen)
    checks.update(kchecks)

    # N4's iteration counts: batch row 0's slabs, twice, against the
    # unsharded N4 of its lanes
    lanes = hp_d[:BATCH // nb]
    m0 = mask_d[:BATCH // nb]
    N, H, W, D = lanes.shape
    h = H // ns
    P = cfg.n4_mask_pad

    def row0_slabs():
        runs = []
        for s in range(ns):
            x, m = lanes[:, s * h:(s + 1) * h], m0[:, s * h:(s + 1) * h]
            i, v, c = sort_compact_masked(x.reshape(N, -1),
                                          m.reshape(N, -1) > 0,
                                          min(P, h * W * D))
            runs.append((i + s * h * W * D, v, c))
        return n4_slabs([lanes[:, s * h:(s + 1) * h].contiguous()
                         for s in range(ns)], runs, (H, W, D), P,
                        fitting_levels=cfg.n4_fitting_levels,
                        max_iters=cfg.n4_max_iters,
                        convergence_threshold=cfg.n4_convergence_threshold,
                        bins=cfg.n4_histogram_bins, fwhm=cfg.n4_bias_fwhm,
                        wiener_noise=cfg.n4_wiener_noise,
                        control_points=cfg.n4_control_points)

    it1, it2 = row0_slabs()[2], row0_slabs()[2]
    comp = sort_compact_masked(lanes.reshape(N, -1),
                               m0.reshape(N, -1) > 0, P)
    _, _, it_u = n4_call(lanes, m0, cfg, return_overflow=True,
                         return_iters=True, compacted=comp)
    checks["n4_iters_repeat_identical"] = torch.equal(it1, it2)
    checks["n4_iters_equal_unsharded"] = torch.equal(it1, it_u)
    log(f"space: N4 iterations of batch row 0 over {ns} slabs "
        f"{it1.tolist()}, unsharded {it_u.tolist()}")

    # 2. path i's oversize geometry as one study over a (1, 4) mesh
    ob, os_ = SPACE_OVERSIZE_MESH
    ohp, omask, _ = make_cohort(1, OVERSIZE, VOX, seed=SEED)
    n_mask = int((omask > 0).sum())
    ocfg = DEFAULT_CONFIG.replace(
        n4_mask_pad=min(int(np.prod(OVERSIZE)), -(-n_mask // 8192) * 8192))
    ogeom = build_geometry(VOX, OVERSIZE, ocfg)
    ohp_d, omask_d = torch.from_numpy(ohp).to(dev), torch.from_numpy(
        omask).to(dev)
    cards = torch.cuda.device_count()
    odevs = ([torch.device("cuda", i) for i in range(os_)]
             if cards >= os_ else [dev] * os_)
    for d in set(odevs):
        torch.cuda.reset_peak_memory_stats(d)
    base = {d: torch.cuda.memory_allocated(d) for d in set(odevs)}
    ofn = spatial_shard_fn(functools.partial(analyze_cohort, geom=ogeom,
                                             config=ocfg),
                           make_batch_space_mesh(ob, os_, devices=odevs))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ogot = ofn(ohp_d, omask_d)
    torch.cuda.synchronize()
    times["oversize_host_ms"] = (time.perf_counter() - t0) * 1e3
    counts["oversize"] = launch_counts()
    checks["oversize_kernels"] = space_required(counts["oversize"], ob, os_)
    peaks = {str(d): torch.cuda.max_memory_allocated(d) - base[d]
             for d in sorted(set(odevs), key=str)}
    torch.cuda.reset_peak_memory_stats(dev)
    base_u = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    owant = analyze_cohort(ohp_d, omask_d, ogeom, ocfg)
    torch.cuda.synchronize()
    times["oversize_unsharded_host_ms"] = (time.perf_counter() - t0) * 1e3
    peak_u = torch.cuda.max_memory_allocated(dev) - base_u
    o_dev = space_compare(ogot, owant, "oversize", checks)
    oagain = ofn(ohp_d, omask_d)
    checks["oversize_repeat_bit_identical"] = all(
        torch.equal(getattr(ogot, f), getattr(oagain, f))
        for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"))
    log(f"space oversize {OVERSIZE} over ({ob}, {os_}): {n_mask} mask "
        f"voxels, n4_mask_pad {ocfg.n4_mask_pad}, ci_overflow "
        f"{bool(ogot.metrics.ci_overflow[0])}; launches "
        f"{json.dumps(counts['oversize'])}; host ms "
        f"{times['oversize_host_ms']!r} (unsharded "
        f"{times['oversize_unsharded_host_ms']!r}); peak bytes allocated "
        f"above the start: by device {json.dumps(peaks)} "
        f"({'one shard a card' if cards >= os_ else 'all shards on the one card'}"
        f"), unsharded {peak_u}")
    times["oversize_peak_bytes"] = peaks
    times["oversize_unsharded_peak_bytes"] = peak_u

    # 3. the train step at base 16 on path h's training shapes over a (2, 4)
    #    mesh, 3 steps from the same state as train_step's
    tb, ts = SPACE_TRAIN_MESH
    make = lambda: seg.create_train_state(
        torch.Generator().manual_seed(SEED), shape=SHAPE[:2], base=16,
        learning_rate=1e-3, device=dev)
    ref, state = make(), make()
    step = seg.make_sharded_train_step(state, make_batch_space_mesh(
        tb, ts, devices=[dev] * (tb * ts)))
    lerr, ms_s, ms_u = [], [], []
    for i in range(SPACE_TRAIN_STEPS):
        _, mask, proton = make_random_cohort(SEG_BATCH, shape=SHAPE,
                                             seed=SEED + 1 + i * SEG_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = float(seg.train_step(ref, proton, mask))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got_l = float(step(state, proton, mask))
        torch.cuda.synchronize()
        ms_u.append((t1 - t0) * 1e3)
        ms_s.append((time.perf_counter() - t1) * 1e3)
        lerr.append(abs(got_l - want) / abs(want))
    perr = max(float((p.detach() - q.detach()).abs().max()) for p, q in zip(
        state.model.parameters(), ref.model.parameters()))
    checks["train_loss_within_1e-5"] = max(lerr) <= 1e-5
    checks["train_params_within_step_atol"] = perr <= SEG_STEP_ATOL
    times["train_step_ms"] = ms_s
    times["train_step_unsharded_ms"] = ms_u
    log(f"space train step over ({tb}, {ts}), base 16, {SEG_BATCH} x "
        f"{SHAPE}: loss relative differences {lerr!r}, parameters max |d| "
        f"after {SPACE_TRAIN_STEPS} steps {perr!r}; step host ms {ms_s!r} "
        f"(unsharded {ms_u!r})")

    checks = {k: bool(x) for k, x in checks.items()}
    log(f"space checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the space path failed: {checks}")
    by_entry = {e: counts["headline"][e] + counts["oversize"][e]
                for e in SPACE_ENTRIES}
    launches = {k: 0 for k in KERNELS}
    for run in counts.values():
        for k, v in run.items():
            rec = SPACE_KERNELS.get(k, k)
            if rec in launches:
                launches[rec] += v
    times["n4_max_abs_dev"] = {"headline": n4_dev, "oversize": o_dev}
    times["path_s"] = time.perf_counter() - t_path
    log(f"time space (host clock): {json.dumps(times)}")
    return launches, by_entry, err, times


# ---------------------------------------------------------------------------
# Path m: the space axis over torch.distributed ranks (one slab a rank)
# ---------------------------------------------------------------------------

RANK_MESH = (2, 2)            # the headline: four gloo ranks on the card
RANK_OVERSIZE_MESH = (1, 4)   # path l's oversize study, four gloo ranks
RANK_TRAIN_MESH = (2, 2)      # the train step: 4 lanes a row, 64-row slabs
RANK_TIMEOUT = 300            # s a collective may wait (init_process_group)
RESULT_FIELDS = ("n4", "defect", "defect_lb", "defect_km", "defect_border",
                 "ci_map")


def save_result(res, path):
    """A VentResult's volumes and metrics as an .npz of host arrays."""
    import dataclasses

    leaves = {f: getattr(res, f).cpu().numpy() for f in RESULT_FIELDS}
    leaves.update({f"metrics.{f.name}": getattr(res.metrics, f.name).cpu()
                   .numpy() for f in dataclasses.fields(res.metrics)})
    np.savez(path, **leaves)


def result_differences(res, path):
    """The fields of ``res`` whose bits differ from the saved result's
    (NaN equal to NaN), and a digest of ``res``'s bytes."""
    import dataclasses
    import hashlib

    want = np.load(path)
    got = {f: getattr(res, f).cpu().numpy() for f in RESULT_FIELDS}
    got.update({f"metrics.{f.name}": getattr(res.metrics, f.name).cpu()
                .numpy() for f in dataclasses.fields(res.metrics)})
    digest = hashlib.sha256()
    bad = []
    for k in sorted(want.files):
        a, b = got[k], want[k]
        digest.update(a.tobytes())
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"):
            bad.append(k)
    return bad, digest.hexdigest()


def rank_space(port, rank, world, backend, data):
    """One rank of path m: for each run of data/space.json, a
    RankSpaceMesh of the group and spatial_shard_fn over it (headline,
    oversize) or the sharded train step (train).  An analysis run is
    counted in its own window and held bit for bit to the saved unsharded
    result; a timed repeat captures each kernel's operands at this rank's
    slab shapes, held to the plain versions; the headline also runs N4
    over this row's slabs for its iteration counts.  Prints one RANK_OK
    line."""
    import functools
    import hashlib
    import os

    import torch.distributed as tdist

    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.dist import (
        initialize_multihost, make_rank_space_mesh, space, spatial_shard_fn,
    )
    from ventjax_torch.io.phantom import make_random_cohort
    from ventjax_torch.models import segmentation as seg
    from ventjax_torch.ops.basic import sort_compact_masked
    from ventjax_torch.ops.n4_space import n4_slabs
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    with open(f"{data}/space.json") as f:
        job = json.load(f)
    if job["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("chip_smoke --rank: no CUDA card")
    cuda = job["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_multihost(f"localhost:{port}", world, rank, backend=backend,
                         timeout=RANK_TIMEOUT)
    out = {"rank": rank, "world": world, "backend": tdist.get_backend(),
           "cpu_threads": [os.cpu_count(), torch.get_num_threads()],
           "runs": {}}
    for name in job["runs"]:
        spec = job[name]
        nb, ns = spec["mesh"]
        mesh = make_rank_space_mesh(nb, ns, job["device"])
        dev = mesh.device
        rec = out["runs"][name] = {"row": mesh.row, "slab": mesh.slab}
        if name == "train":
            shape, batch = tuple(spec["shape"]), spec["batch"]
            state = seg.create_train_state(
                torch.Generator().manual_seed(SEED), shape=shape[:2],
                base=spec["base"], learning_rate=1e-3, device=dev)
            step = seg.make_sharded_train_step(state, mesh)
            losses, ms = [], []
            for i in range(len(spec["losses"])):
                _, mask, proton = make_random_cohort(
                    batch, shape=shape, seed=SEED + 1 + i * batch)
                tdist.barrier()
                sync()
                t0 = time.perf_counter()
                losses.append(float(step(state, proton, mask)))
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            digest = hashlib.sha256()
            for p in state.model.parameters():
                digest.update(p.detach().cpu().numpy().tobytes())
            rec.update(losses=losses, step_ms=ms,
                       params=digest.hexdigest(),
                       loss_rel=[abs(a - b) / abs(b) for a, b in
                                 zip(losses, spec["losses"])])
            continue
        hp = torch.from_numpy(np.load(spec["hp"])).to(dev)
        mask = torch.from_numpy(np.load(spec["mask"])).to(dev)
        cfg = DEFAULT_CONFIG.replace(**spec["config"])
        geom = build_geometry(VOX, tuple(hp.shape[1:]), cfg)
        fn = spatial_shard_fn(functools.partial(analyze_cohort, geom=geom,
                                                config=cfg), mesh)
        tdist.barrier()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        reset_counts()
        t0 = time.perf_counter()
        got = fn(hp, mask)
        sync()
        rec["first_ms"] = (time.perf_counter() - t0) * 1e3
        rec["launches"] = launch_counts()
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) - base
                             if cuda else None)
        rec["differs"], rec["digest"] = result_differences(got,
                                                           spec["want"])
        tdist.barrier()
        sync()
        t0 = time.perf_counter()
        again, seen = capture_space(lambda: fn(hp, mask))
        sync()
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec["repeat_identical"] = result_differences(
            again, spec["want"])[1] == rec["digest"]
        kchecks, rec["err"], rec["k2_by_output"] = check_space_kernels(seen)
        rec["kernel_checks"] = kchecks
        if "iters" in spec:
            # N4 over this row's slabs, one a rank: its iteration counts
            per = hp.shape[0] // nb
            H, W, D = hp.shape[1:]
            h, P = H // ns, cfg.n4_mask_pad
            lanes = slice(mesh.row * per, (mesh.row + 1) * per)
            x = hp[lanes, mesh.slab * h:(mesh.slab + 1) * h].contiguous()
            m = mask[lanes, mesh.slab * h:(mesh.slab + 1) * h]
            i, v, c = sort_compact_masked(x.reshape(per, -1),
                                          m.reshape(per, -1) > 0,
                                          min(P, h * W * D))
            with space.on_ranks(mesh.row_ranks):
                its = n4_slabs(
                    [x], [(i + mesh.slab * h * W * D, v, c)], (H, W, D), P,
                    fitting_levels=cfg.n4_fitting_levels,
                    max_iters=cfg.n4_max_iters,
                    convergence_threshold=cfg.n4_convergence_threshold,
                    bins=cfg.n4_histogram_bins, fwhm=cfg.n4_bias_fwhm,
                    wiener_noise=cfg.n4_wiener_noise,
                    control_points=cfg.n4_control_points)[2]
            rec["iters"] = its.tolist()
            rec["iters_equal"] = its.cpu().numpy().tolist() == np.load(
                spec["iters"])[lanes].tolist()
    tdist.destroy_process_group()
    print("RANK_OK " + json.dumps(out), flush=True)


def phase_ranks(dev, cfg, geom, hp, mask, hp_d, mask_d, res):
    """Path m: the space axis over torch.distributed ranks (see the module
    docstring).  Returns (launches per kernel record, summed over every
    rank's counted windows, max errors, timings)."""
    import os
    import tempfile

    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.io.phantom import make_cohort, make_random_cohort
    from ventjax_torch.models import segmentation as seg
    from ventjax_torch.ops.basic import sort_compact_masked
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    t_path = time.perf_counter()
    checks, times, err = {}, {}, {}
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as root:
        f = lambda name: os.path.join(root, name)
        np.save(f("hp.npy"), hp)
        np.save(f("mask.npy"), mask)
        save_result(res, f("want.npz"))
        N = hp_d.shape[0]
        comp = sort_compact_masked(hp_d.reshape(N, -1),
                                   mask_d.reshape(N, -1) > 0,
                                   cfg.n4_mask_pad)
        np.save(f("iters.npy"), n4_call(hp_d, mask_d, cfg,
                                        return_overflow=True,
                                        return_iters=True,
                                        compacted=comp)[2].cpu().numpy())
        # path l's oversize study, unsharded
        ohp, omask, _ = make_cohort(1, OVERSIZE, VOX, seed=SEED)
        n_mask = int((omask > 0).sum())
        ocfg = DEFAULT_CONFIG.replace(n4_mask_pad=min(
            int(np.prod(OVERSIZE)), -(-n_mask // 8192) * 8192))
        ohp_d = torch.from_numpy(ohp).to(dev)
        omask_d = torch.from_numpy(omask).to(dev)
        ogeom = build_geometry(VOX, OVERSIZE, ocfg)
        owant = analyze_cohort(ohp_d, omask_d, ogeom, ocfg)
        torch.cuda.synchronize()
        times["oversize_unsharded_host_ms"] = host_ms(
            lambda: analyze_cohort(ohp_d, omask_d, ogeom, ocfg), reps=3)
        times["headline_unsharded_host_ms"] = host_ms(
            lambda: analyze_cohort(hp_d, mask_d, geom, cfg), reps=3)
        np.save(f("ohp.npy"), ohp)
        np.save(f("omask.npy"), omask)
        save_result(owant, f("owant.npz"))
        # train_step's losses from the same state on the same batches
        ref = seg.create_train_state(torch.Generator().manual_seed(SEED),
                                     shape=SHAPE[:2], base=16,
                                     learning_rate=1e-3, device=dev)
        losses = []
        for i in range(SPACE_TRAIN_STEPS):
            _, m, p = make_random_cohort(SEG_BATCH, shape=SHAPE,
                                         seed=SEED + 1 + i * SEG_BATCH)
            losses.append(float(seg.train_step(ref, p, m)))
        keep = lambda c: {k: getattr(c, k) for k in (
            "n4_mask_pad", "ci_max_defect_voxels")}
        headline = {"hp": f("hp.npy"), "mask": f("mask.npy"),
                    "want": f("want.npz"), "iters": f("iters.npy"),
                    "config": keep(cfg)}
        jobs = {
            "gloo": {"device": "cuda", "runs": ["headline", "oversize",
                                                "train"],
                     "headline": {**headline, "mesh": RANK_MESH},
                     "oversize": {"hp": f("ohp.npy"),
                                  "mask": f("omask.npy"),
                                  "want": f("owant.npz"),
                                  "config": keep(ocfg),
                                  "mesh": RANK_OVERSIZE_MESH},
                     "train": {"mesh": RANK_TRAIN_MESH, "losses": losses,
                               "shape": SHAPE, "batch": SEG_BATCH,
                               "base": 16}},
            "nccl": {"device": "cuda", "runs": ["headline"],
                     "headline": {**headline, "mesh": (1, 1)}},
        }
        recs = {}
        for backend, job in jobs.items():
            os.makedirs(f(backend))
            with open(os.path.join(f(backend), "space.json"), "w") as fh:
                json.dump(job, fh)
            world = 4 if backend == "gloo" else 1
            t0 = time.perf_counter()
            recs[backend] = finish_ranks(start_ranks(world, backend,
                                                     f(backend)),
                                         timeout=420)
            times[f"{backend}_ranks_s"] = time.perf_counter() - t0
    for backend, rs in recs.items():
        checks[f"{backend}_backend"] = all(r["backend"] == backend
                                           for r in rs)
        for run in rs[0]["runs"]:
            tag = f"{backend}_{run}"
            per = [r["runs"][run] for r in rs]
            if run == "train":
                checks[f"{tag}_loss_within_1e-6"] = max(
                    max(p["loss_rel"]) for p in per) <= 1e-6
                checks[f"{tag}_params_identical_across_ranks"] = len(
                    {p["params"] for p in per}) == 1
                times[f"{tag}_step_ms"] = [p["step_ms"] for p in per]
                log(f"ranks {tag}: loss relative differences "
                    f"{[p['loss_rel'] for p in per]!r}; step host ms "
                    f"{[p['step_ms'] for p in per]!r}")
                continue
            checks[f"{tag}_bit_equal"] = all(not p["differs"] for p in per)
            checks[f"{tag}_same_on_every_rank"] = len(
                {p["digest"] for p in per}) == 1
            checks[f"{tag}_repeat_identical"] = all(p["repeat_identical"]
                                                    for p in per)
            if "iters" in per[0]:
                checks[f"{tag}_iterations_equal"] = all(p["iters_equal"]
                                                        for p in per)
            for p in per:
                where = f"{tag}_rank_row{p['row']}_slab{p['slab']}"
                n = p["launches"]
                checks[f"{where}_kernels"] = all(n[k] > 0 for k in (
                    "fit_moment_partial", "fit_delta_conv_field",
                    "sharpen_hist_partial", "sharpen_resid", "n4_field")) \
                    and (n["head_counts"] > 0) == (p["slab"] == 0)
                for k, ok in p["kernel_checks"].items():
                    checks[f"{where}_{k}"] = ok
                for k, e in p["err"].items():
                    err[k] = max(err.get(k, 0.0), e)
                for k, v in n.items():
                    rec = SPACE_KERNELS.get(k, k)
                    if rec in launches:
                        launches[rec] += v
            times[f"{tag}_host_ms"] = [p["ms"] for p in per]
            times[f"{tag}_first_host_ms"] = [p["first_ms"] for p in per]
            times[f"{tag}_peak_bytes"] = [p["peak_bytes"] for p in per]
            log(f"ranks {tag} ({len(per)} ranks): differing fields "
                f"{[p['differs'] for p in per]}; "
                f"launches {json.dumps([p['launches'] for p in per])}; "
                f"host ms {[round(p['ms'], 2) for p in per]} (first "
                f"{[round(p['first_ms'], 2) for p in per]}); peak bytes "
                f"above the start {[p['peak_bytes'] for p in per]}; kernel "
                f"errors against the plain versions "
                f"{json.dumps([p['err'] for p in per])}; K2 by output "
                f"{json.dumps([p['k2_by_output'] for p in per])}")
    checks = {k: bool(v) for k, v in checks.items()}
    log("ranks' cpu count and torch threads: " + json.dumps(
        {b: [r["cpu_threads"] for r in rs] for b, rs in recs.items()}))
    log(f"ranks checks: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"the space axis over ranks failed: {checks}")
    times["path_s"] = time.perf_counter() - t_path
    log(f"time ranks (host clock): {json.dumps(times)}")
    return launches, err, times


def phase_doctor():
    """The deployment self-check on the card: every required check passed
    and kernel_build naming the five libraries."""
    from ventjax_torch.utils.doctor import run_doctor

    t0 = time.perf_counter()
    rep = run_doctor(full=True)
    by = {c["name"]: c for c in rep["checks"]}
    log(f"doctor (full) in {time.perf_counter() - t0:.1f} s: ok={rep['ok']}; "
        + json.dumps({n: {k: v for k, v in c.items() if k != "name"}
                      for n, c in by.items()}))
    built = sorted(by["kernel_build"].get("libraries", {}))
    if not (rep["ok"] and by["kernel_build"]["required"]
            and built == sorted(LIBS)):
        raise AssertionError(f"the doctor failed on the card: {rep}")


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


# Peaks of one H100 SXM at 700 W:
# HBM3 bytes per second and float32 FLOP/s on the CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound(nbytes, flops):
    """(least ms the card could take, "bytes" or "operations"): each input
    byte read once and each output byte written once at the memory rate,
    against the operations at the float32 peak."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def device_events(prof):
    """The device activities of a profile (kernels, copies, fills) in time
    order.  The device-side ranges of record_function annotations (the
    pipeline's stages) span other activities and are left out."""
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)


def device_ms(fn, reps=20, tries=5, flush=None, count=False):
    """Device time per call of fn in ms: the summed duration of the device
    activities (kernels, copies, fills) that reps calls enqueue, taken by
    torch.profiler, so host launch overhead between them does not count.
    The profiler can lose the first activities of a session (a one-call
    session once recorded none, a K1 turn a tenth of the others; some
    sessions lost their first seven, a flushed K5 session its first ten),
    so each session starts with short spin kernels and calls that are not
    counted, and spin kernels mark one call and then the reps timed calls
    (the last three marks; without flush the fourth from last may be
    lost); a session counts only if the timed calls hold reps times the one
    call's activities.  With flush (a call that evicts the L2 cache), every
    counted call follows a flush, and the activities named as a lone
    flush's are not counted.  With count, returns (ms, device activities
    of one call)."""
    from torch.profiler import ProfilerActivity, profile

    step = fn if flush is None else (lambda: (flush(), fn()))
    fn()
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(24):   # fillers for the activities it loses
                torch.cuda._sleep(100)
            for _ in range(8):
                fn()
            torch.cuda._sleep(1000)
            if flush is not None:
                flush()
            torch.cuda._sleep(1000)
            step()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                step()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = device_events(prof)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        seen.append((len(events), len(marks)))
        if len(marks) < 4 and (flush is not None or len(marks) != 3):
            continue
        skip = {e.name for e in events[marks[-4] + 1:marks[-3]]} \
            if flush is not None else set()
        one = events[marks[-3] + 1:marks[-2]]
        timed = events[marks[-2] + 1:marks[-1]]
        seen[-1] += (len(one), len(timed))
        if (flush is None or skip) and one and len(timed) == len(one) * reps:
            ms = sum(e.time_range.elapsed_us() for e in timed
                     if e.name not in skip) / reps / 1e3
            return (ms, len(one)) if count else ms
    if count or flush is not None:
        raise RuntimeError(f"torch.profiler lost device activities in {tries} "
                           f"sessions (activities, marks, one, timed): {seen}")
    # a call the profiler keeps losing is timed by CUDA events, which count
    # the host's launch gaps too: the value says so (EventsMs), and each
    # kernel record lists such keys in timed_by_events
    ms = EventsMs(cuda_ms(fn, reps))
    log(f"device_ms: torch.profiler lost device activities in {tries} "
        f"sessions (activities, marks, one, timed): {seen}; timed by CUDA "
        f"events instead: {ms:.4f} ms")
    return ms


class EventsMs(float):
    """A device_ms time taken by CUDA events (host launch gaps included)
    after torch.profiler lost the call's activities."""


def events_timed(rec, path=""):
    """The dotted keys of the nested record rec whose times are EventsMs."""
    out = []
    for k, v in rec.items():
        if isinstance(v, EventsMs):
            out.append(path + k)
        elif isinstance(v, dict):
            out += events_timed(v, f"{path}{k}.")
    return out


def l2_flusher(dev):
    """A call that evicts the card's 50 MB L2 cache: a 128 MB fill."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    return lambda: buf.fill_(1)


def nnz_rows(rows):
    """[N, P] count of non-zero basis entries per voxel of [N, ncp, P]."""
    return (rows != 0).sum(1).double()


def k3_box_distances(centers, witnesses, r2, combos, scale, rmax):
    """The distances K3's function needs on this run's data: one for each
    (center, witness, alias combo) whose offset lies in the rmax box, since
    no other offset can reach a ball.  Counted on the card, 256 centers at
    a time."""
    n = 0
    for a in range(0, centers[0].shape[1], 256):
        vi, vj, vk = (c[:, a:a + 256, None] for c in centers)
        wi, wj, wk = (w[:, None, :] for w in witnesses)
        for p, q, s in combos:
            n += int((((wi - vi + p).abs() <= rmax)
                      & ((wj - vj + q).abs() <= rmax)
                      & ((wk - vk + s).abs() <= rmax)).sum())
    return float(n)


def k8_record(defect, K, dev):
    """K8 on one batch of defect maps at pad K: device ms of the kernel, its
    plain version, the scatter it replaces (the CI map's default route) and
    the K9 + K8 pair, and its bound: d01 in and the map out (5 bytes a
    voxel), the 32-byte rank sectors that hold a defect, and cv (bound_9B_ms
    is the earlier count, rank read for every voxel)."""
    from ventjax_torch.ops import ci_densify_cuda as cd
    from ventjax_torch.ops import ci_pairwise as tcp

    V = int(np.prod(SHAPE))
    d01 = (defect != 0).reshape(BATCH, V)
    rank = cd.rank(d01)
    cv = torch.rand((BATCH, K), device=dev)
    _, cidx, _, valid = tcp.defect_coords(defect, K)

    def scatter():
        flat = torch.zeros((BATCH, V + 1), device=dev)
        flat.scatter_(1, torch.where(valid, cidx, torch.full_like(cidx, V)),
                      cv)
        return flat[:, :V].reshape(defect.shape)

    sectors = int(torch.unique(torch.nonzero(d01.reshape(-1))[:, 0]
                               // 8).numel())
    b8 = bound(BATCH * V * 5 + 32 * sectors + BATCH * K * 4, 0)
    return {"ms": device_ms(lambda: cd.densify_rank(rank, d01, cv, K)),
            "plain_ms": device_ms(lambda: cd.densify_rank_plain(
                rank, d01, cv, K)),
            "library_ms": None, "bound_ms": b8[0], "bound_by": b8[1],
            "bound_9B_ms": bound(BATCH * V * 9 + BATCH * K * 4, 0)[0],
            "scatter_ms": device_ms(scatter),
            "pair_ms": device_ms(lambda: cd.densify_rank(cd.rank(d01), d01,
                                                         cv, K)),
            "defect_share": float(d01.float().mean()),
            "rank_sectors": sectors}


def k9_record(defect):
    """K9 on one batch of defect maps: device ms of the kernel (and its
    device activities per call), its plain version and cumsum, and its
    bound: d01 in and the ranks out, 5 bytes a voxel."""
    from ventjax_torch.ops import ci_densify_cuda as cd

    d01 = (defect != 0).reshape(BATCH, -1)
    ms, per_call = device_ms(lambda: cd.rank(d01), count=True)
    b9 = bound(d01.numel() * 5, 0)
    return {"ms": ms, "launches_per_call": per_call,
            "plain_ms": device_ms(lambda: cd.rank_plain(d01)),
            "library_ms": device_ms(lambda: torch.cumsum(
                d01, 1, dtype=torch.int32)),
            "bound_ms": b9[0], "bound_by": b9[1],
            "defect_share": float(d01.float().mean())}


def k1_record(a, r, wv):
    """K1 at one shape: device ms of the kernel, its plain version and the
    one-call einsum yardstick, and its bound (the multiply-adds that the
    non-zero rows of voxels with a != 0 need)."""
    from ventjax_torch.ops import n4_cuda

    N, ncp, P = r[0].shape
    lib = lambda: torch.einsum("np,ncp,ndp,nep->ncde", a, *r).reshape(
        N, ncp, ncp * ncp)
    lib_err = scaled_err(lib(), n4_cuda.fit_moment_plain(a, *r))
    terms = float(((a != 0).double() * nnz_rows(r[0]) * nnz_rows(r[1])
                   * nnz_rows(r[2])).sum())
    b, by = bound(N * P * (1 + 3 * ncp) * 4 + N * ncp ** 3 * 4, 2 * terms)
    return {"ms": device_ms(lambda: n4_cuda.fit_moment(a, *r)),
            "plain_ms": device_ms(lambda: n4_cuda.fit_moment_plain(a, *r)),
            "library_ms": device_ms(lib, reps=5), "bound_ms": b,
            "bound_by": by, "library_rel_err": lib_err}


def k2_record(phi, r1, wv, logv, done):
    from ventjax_torch.ops import n4_cuda

    N, ncp, P = r1[0].shape
    c, d, e = (nnz_rows(x) for x in r1)
    terms = float((c * d * e + c * d + c).sum())
    b, by = bound(N * P * (3 * ncp + 5) * 4 + N * (ncp ** 3 + 4) * 4,
                  2 * terms)
    return {"ms": device_ms(lambda: n4_cuda.fit_delta_conv_field(
                phi, *r1, wv, wv, logv, done)),
            "plain_ms": device_ms(lambda: n4_cuda.fit_delta_conv_field_plain(
                phi, *r1, wv, wv, logv, done)),
            "library_ms": None, "bound_ms": b, "bound_by": by}


def field_record(phi):
    """The dense-field kernel on N4's lattices of the headline batch:
    device ms of the kernel, its plain version and the 12 bmm it replaced
    (no one PyTorch call computes the sum over levels: library_ms null),
    and its bound: the lattices and tables in and the field out at the
    memory rate, against the float32 operations of the separable
    evaluation (7 a term of each 4-term contraction over (c, d, s), (c, w,
    s) and the voxels, and the level sums) at the float32 peak."""
    from ventjax_torch.ops import n4_field_cuda as nf

    N = phi.shape[0]
    H, W, D = SHAPE
    V = H * W * D
    ops = N * (sum(7 * (c * c * D + c * W * D + V) for c in FIELD_NCPS)
               + (len(FIELD_NCPS) - 1) * V)
    nbytes = (phi.numel() * 4 + len(FIELD_NCPS) * (H + W + D) * 20
              + N * V * 4)
    b, by = bound(nbytes, ops)
    bmm_err = scaled_err(nf.n4_field_bmm(phi, SHAPE, FIELD_NCPS),
                         nf.n4_field_plain(phi, SHAPE, FIELD_NCPS))
    return {"ms": device_ms(lambda: nf.n4_field(phi, SHAPE, FIELD_NCPS)),
            "plain_ms": device_ms(lambda: nf.n4_field_plain(
                phi, SHAPE, FIELD_NCPS), reps=5),
            "library_ms": None,
            "bmm_ms": device_ms(lambda: nf.n4_field_bmm(
                phi, SHAPE, FIELD_NCPS), reps=5),
            "bmm_rel_err": bmm_err, "bound_ms": b, "bound_by": by}


def phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad, dev):
    """Slice vol/s (median of 5 synchronised runs), the N4 and CI stages,
    and each kernel's device time beside its plain version's, its one-call
    PyTorch yardstick where there is one, and its bound, at the main
    path's shapes (K1 and K2 at every ncp N4 runs, K4 and K5 on the first
    and a late residual).  Returns {kernel: record}."""
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
    from ventjax_torch.ops.ci import calculate_ci_staged
    from ventjax_torch.pipeline import build_geometry

    lgeom = build_geometry(VOX, SHAPE, cfg.replace(ci_engine="ladder"))
    stages = {
        "n4": host_ms(lambda: n4_call(hp_d, mask_d, cfg), reps=3)[0],
        "ci_scatter": host_ms(lambda: tcp.calculate_ci_pairwise(
            res.defect, geom, K, tail_k=cfg.ci_tail_k))[0],
        "ci_densify": host_ms(lambda: tcp.calculate_ci_pairwise(
            res.defect, geom, K, tail_k=cfg.ci_tail_k,
            pallas_densify=True))[0],
        "ci_ladder": host_ms(lambda: calculate_ci_staged(
            res.defect, lgeom, K))[0],
    }
    log("stages, median ms (host clock, synchronised): "
        + json.dumps({k: round(v, 2) for k, v in stages.items()}))

    rec = {}
    gen = np.random.default_rng(SEED + 2)
    for ncp in FIT_NCPS:
        bv, wv, logv = fit_inputs(hp, mask, n4_pad, ncp, dev)
        r1, r3 = ([tn4._rows(b, k) for b in bv] for k in (1, 3))
        a = smooth_residual(wv, gen)
        phi = torch.full((BATCH, ncp, ncp * ncp), 0.05, device=dev)
        done = torch.zeros(BATCH, device=dev)
        for name, r in (("fit_moment", k1_record(a, r3, wv)),
                        ("fit_delta_conv_field",
                         k2_record(phi, r1, wv, logv, done))):
            rec.setdefault(name, {"by_shape": {}})["by_shape"][
                f"ncp{ncp}"] = r
        if ncp == 11:
            phi4 = phi.reshape(BATCH, ncp, ncp, ncp)
            c, d, e = (nnz_rows(x) for x in r1)
            terms = float((c * d * e + c * d + c).sum())
            nb = BATCH * n4_pad * 3 * ncp * 4 + BATCH * ncp ** 3 * 4
            b6 = bound(nb + BATCH * n4_pad * 4, 2 * terms)
            b7 = bound(nb + BATCH * n4_pad * 8 + BATCH * 8, 2 * terms)
            rec["fit_delta"] = {
                "ms": device_ms(lambda: n4_cuda.fit_delta(phi, *r1)),
                "plain_ms": device_ms(lambda: n4_cuda.fit_delta_plain(
                    phi, *r1)),
                "library_ms": device_ms(lambda: torch.einsum(
                    "ncde,ncp,ndp,nep->np", phi4, *r1), reps=5),
                "bound_ms": b6[0], "bound_by": b6[1]}
            rec["fit_delta_conv"] = {
                "ms": device_ms(lambda: n4_cuda.fit_delta_conv(
                    phi, *r1, wv)),
                "plain_ms": device_ms(lambda: n4_cuda.fit_delta_conv_plain(
                    phi, *r1, wv)),
                "library_ms": None, "bound_ms": b7[0], "bound_by": b7[1]}
    for name in ("fit_moment", "fit_delta_conv_field"):
        rec[name].update({k: v for k, v in rec[name]["by_shape"][
            "ncp11"].items() if k != "library_rel_err"})

    flush = l2_flusher(dev)
    for tag, (logu, wv, sv, bmn, slope) in (
            ("first", sharpen_inputs(hp, mask, n4_pad, dev)),
            ("late", late_residual(hp, mask, n4_pad, dev))):
        e_loc = expectation(sc.sharpen_hist(logu, wv, bmn, slope, BINS),
                            bmn, slope)
        nv = BATCH * n4_pad
        b4 = bound(nv * 8 + BATCH * (BINS + 2) * 4, 0)
        b5 = bound(nv * 16 + BATCH * (BINS + 4) * 4, 0)
        rec.setdefault("sharpen_hist", {"by_shape": {}})["by_shape"][tag] = {
            "ms": device_ms(lambda: sc.sharpen_hist(logu, wv, bmn, slope,
                                                    BINS)),
            "plain_ms": device_ms(lambda: sc.sharpen_hist_plain(
                logu, wv, bmn, slope, BINS)),
            "library_ms": None, "bound_ms": b4[0], "bound_by": b4[1]}
        resid = lambda: sc.sharpen_resid(logu, wv, sv, e_loc, bmn, slope,
                                         BINS)
        rec.setdefault("sharpen_resid", {"by_shape": {}})["by_shape"][tag] = {
            "ms": device_ms(resid), "cold_ms": device_ms(resid, flush=flush),
            "plain_ms": device_ms(lambda: sc.sharpen_resid_plain(
                logu, wv, sv, e_loc, bmn, slope, BINS)),
            "library_ms": None, "bound_ms": b5[0], "bound_by": b5[1]}
    for name in ("sharpen_hist", "sharpen_resid"):
        rec[name].update(rec[name]["by_shape"]["late"])

    coords = tcp.defect_coords(res.defect, K)[0]
    by_k = {}
    for k, c in ((K, coords), (2048, severe_coords(2048, dev)),
                 (4096, severe_coords(4096, dev))):
        args = k3_args(c, geom)
        ns = args[2].shape[0]
        # 8 float32 operations a distance: three scalings, three squares and
        # two adds
        b3 = bound(BATCH * k * (6 * 4 + ns * 4), 8 * k3_box_distances(*args))
        by_k[f"K{k}"] = {
            "ms": device_ms(lambda: ci_cuda.head_counts(*args)),
            "plain_ms": device_ms(lambda: ci_cuda.head_counts_plain(*args),
                                  reps=5),
            "library_ms": None, "bound_ms": b3[0], "bound_by": b3[1]}
    rec["head_counts"] = {**by_k[f"K{K}"], "by_shape": by_k}
    by_k = tail_records(geom, dev)
    rec["tail_balls"] = {**by_k["K8192"], "by_shape": by_k}
    by_k = {f"K{k}": k9_record(m)
            for k, m in ((K, res.defect), (4096, severe_map(4096, dev)))}
    rec["rank"] = {**by_k[f"K{K}"], "by_shape": by_k}

    by_k = {f"K{k}": k8_record(m, k, dev)
            for k, m in ((K, res.defect), (4096, severe_map(4096, dev)))}
    rec["densify_rank"] = {**by_k[f"K{K}"], "by_shape": by_k}
    rec["n4_field"] = field_record(slice_lattices(hp, mask, n4_pad, dev))
    for k, r in rec.items():
        for shape, x in ([(None, r)] + sorted(r.get("by_shape", {}).items())):
            log(f"time {k}{'' if shape is None else ' ' + shape}: "
                + " ".join(f"{f} {x[f]:.4f}" for f in (
                    "ms", "cold_ms", "plain_ms", "library_ms", "bmm_ms",
                    "bound_ms", "bound_9B_ms", "scatter_ms", "pair_ms")
                    if x.get(f) is not None) + f" ({x['bound_by']})")
    return med, rec


@contextlib.contextmanager
def lib_of(mod, lib):
    """The wrappers of ops module mod launch from lib inside the block."""
    saved = mod._lib
    mod._lib = lambda: mod._typed(lib)
    try:
        yield
    finally:
        mod._lib = saved


def under(mod, lib, fn):
    """fn, run with the wrappers of mod launching from lib."""
    def run(*args):
        with lib_of(mod, lib):
            return fn(*args)
    return run


def turns(old, new, reps=20, flush=None):
    """Device ms of old and new in turns: old, new, new, old (each call
    after a flush, where one is given: see device_ms)."""
    a = device_ms(old, reps, flush=flush)
    b, c = (device_ms(new, reps, flush=flush) for _ in range(2))
    d = device_ms(old, reps, flush=flush)
    return {"parent_ms": (a + d) / 2, "ms": (b + c) / 2, "turns": [a, b, c, d]}


def sums_ok(new, old, plain, s_scale):
    """The sums (stats[:, :2]) of new bit-equal to old's, or within
    KERNEL_RTOL of the plain version's (s1 against its summed magnitude
    s_scale, s2 against itself)."""
    if torch.equal(new[:, :2], old[:, :2]):
        return True
    return max(float(((new[:, 0] - plain[:, 0]).abs() / s_scale).max()),
               float(((new[:, 1] - plain[:, 1]).abs()
                      / plain[:, 1].abs()).max())) <= KERNEL_RTOL


@contextlib.contextmanager
def older_kernels(libs):
    """Every wrapper launches from the older libraries inside the block."""
    from ventjax_torch.ops import ci_cuda, ci_densify_cuda, n4_cuda
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    with lib_of(n4_cuda, libs["n4_fit"]), lib_of(sc, libs["n4_sharpen"]), \
            lib_of(ci_cuda, libs["ci_head"]), \
            lib_of(ci_densify_cuda, libs["ci_densify"]):
        yield


def phase_parent(parent, hp, mask, n4_pad, dev, res, geom, cfg, hp_d,
                 mask_d):
    """Every kernel of this tree against an older version of its source
    (parent/n4_fit.cu, n4_sharpen.cu, ci_head.cu, ci_densify.cu, with the
    same C interfaces), built here under their own names, in one run:
    device ms in turns (older, this, this, older), K1 both within
    KERNEL_RTOL of the plain version, K4, K5, K3, K9, K8 and K2's, K6's and
    K7's per-voxel outputs bit-equal; then the slice in turns on either set
    of kernels (bit-identical outputs), and one profiled batch on the older
    kernels."""
    from ventjax_torch.pipeline import analyze_cohort

    from pathlib import Path

    from ventjax_torch import _build
    from ventjax_torch.ops import ci_cuda, n4_cuda
    from ventjax_torch.ops import ci_densify_cuda as cd
    from ventjax_torch.ops import ci_pairwise as tcp
    from ventjax_torch.ops import n4 as tn4
    from ventjax_torch.ops import n4_sharpen_cuda as sc

    parent = Path(parent).resolve()
    libs = {n: _build.load(n, parent) for n in PARENT_LIBS}
    old_k2, old_k6, old_k7 = (under(n4_cuda, libs["n4_fit"], f) for f in (
        n4_cuda.fit_delta_conv_field, n4_cuda.fit_delta,
        n4_cuda.fit_delta_conv))
    out = {}
    gen = np.random.default_rng(SEED + 3)
    flush = l2_flusher(dev)

    for ncp in FIT_NCPS:
        bv, wv, logv = fit_inputs(hp, mask, n4_pad, ncp, dev)
        r1, r3 = ([tn4._rows(b, k) for b in bv] for k in (1, 3))
        a = smooth_residual(wv, gen)
        want = n4_cuda.fit_moment_plain(a, *r3)
        old = under(n4_cuda, libs["n4_fit"],
                    lambda: n4_cuda.fit_moment(a, *r3))()
        errs = {"new": scaled_err(n4_cuda.fit_moment(a, *r3), want),
                "parent": scaled_err(old, want)}
        out[f"fit_moment ncp{ncp}"] = {**turns(
            under(n4_cuda, libs["n4_fit"], lambda: n4_cuda.fit_moment(a, *r3)),
            lambda: n4_cuda.fit_moment(a, *r3)), "rel_err": errs}
        if not max(errs.values()) <= KERNEL_RTOL:
            raise AssertionError(f"K1 against the older sources at ncp "
                                 f"{ncp}: {errs}")

        # K2 on N4's power-1 rows, a phi from this moment, frozen lanes
        phi = torch.where(want != 0, want / want.abs().max(),
                          torch.zeros_like(want))
        field = 0.01 * torch.from_numpy(gen.normal(
            size=wv.shape).astype(np.float32)).to(dev) * wv
        done = torch.zeros(BATCH, device=dev)
        done[::3] = 1.0
        k2_args = (phi, *r1, wv, field, logv, done)
        new2, old2 = n4_cuda.fit_delta_conv_field(*k2_args), old_k2(*k2_args)
        plain2 = n4_cuda.fit_delta_conv_field_plain(*k2_args)
        s_scale = (wv * torch.expm1(-n4_cuda.fit_delta_conv_field_plain(
            phi, *r1, wv, torch.zeros_like(wv), logv,
            torch.zeros_like(done))[0])).abs().sum(1)
        same = {"field": bool(torch.equal(new2[0], old2[0])),
                "logu": bool(torch.equal(new2[1], old2[1])),
                "min_max": bool(torch.equal(new2[2][:, 2:], old2[2][:, 2:])),
                "sums": bool(torch.equal(new2[2][:, :2], old2[2][:, :2])),
                "sums_ok": sums_ok(new2[2], old2[2], plain2[2], s_scale),
                "K6": bool(torch.equal(n4_cuda.fit_delta(phi, *r1),
                                       old_k6(phi, *r1)))}
        new7, old7 = (n4_cuda.fit_delta_conv(phi, *r1, wv),
                      old_k7(phi, *r1, wv))
        same["K7_d"] = bool(torch.equal(new7[0], old7[0]))
        same["K7_sums_ok"] = sums_ok(
            new7[1], old7[1], n4_cuda.fit_delta_conv_plain(phi, *r1, wv)[1],
            s_scale)
        out[f"fit_delta_conv_field ncp{ncp}"] = {
            **turns(lambda: old_k2(*k2_args),
                    lambda: n4_cuda.fit_delta_conv_field(*k2_args)),
            "bit_equal": same}
        if not all(v for k, v in same.items() if k != "sums"):
            raise AssertionError(f"K2/K6/K7 against the older sources at "
                                 f"ncp {ncp}: {same}")
        if ncp == 11:
            out["fit_delta ncp11"] = turns(
                lambda: old_k6(phi, *r1), lambda: n4_cuda.fit_delta(phi, *r1))
            out["fit_delta_conv ncp11"] = turns(
                lambda: old_k7(phi, *r1, wv),
                lambda: n4_cuda.fit_delta_conv(phi, *r1, wv))

    for tag, (logu, wv, sv, bmn, slope) in (
            ("first", sharpen_inputs(hp, mask, n4_pad, dev)),
            ("late", late_residual(hp, mask, n4_pad, dev))):
        hist = lambda: sc.sharpen_hist(logu, wv, bmn, slope, BINS)
        old_hist = under(sc, libs["n4_sharpen"], hist)
        same = bool(torch.equal(old_hist(), hist()))
        out[f"sharpen_hist {tag}"] = {**turns(old_hist, hist),
                                      "bit_equal": same}
        if not same:
            raise AssertionError(f"K4 differs from the older K4 ({tag})")
        e_loc = expectation(hist(), bmn, slope)
        resid = lambda: sc.sharpen_resid(logu, wv, sv, e_loc, bmn, slope,
                                         BINS)
        old_resid = under(sc, libs["n4_sharpen"], resid)
        same = bool(torch.equal(old_resid(), resid()))
        out[f"sharpen_resid {tag}"] = {**turns(old_resid, resid),
                                       "bit_equal": same}
        out[f"sharpen_resid {tag} cold"] = turns(old_resid, resid,
                                                 flush=flush)
        if not same:
            raise AssertionError(f"K5 differs from the older K5 ({tag})")

    K = cfg.ci_max_defect_voxels
    slice_coords = tcp.defect_coords(res.defect, K)[0]
    for k, c in ((K, slice_coords), (2048, severe_coords(2048, dev)),
                 (4096, severe_coords(4096, dev))):
        args = k3_args(c, geom)
        head = lambda: ci_cuda.head_counts(*args)
        old_head = under(ci_cuda, libs["ci_head"], head)
        same = bool(torch.equal(old_head(), head()))
        out[f"head_counts K{k}"] = {**turns(old_head, head, reps=5),
                                    "bit_equal": same}
        if not same:
            raise AssertionError(f"K3 differs from the older K3 at K {k}")

    for k, dmap in ((K, res.defect), (4096, severe_map(4096, dev))):
        d01 = (dmap != 0).reshape(BATCH, -1)
        rank = cd.rank(d01)
        cv = torch.rand((BATCH, k), device=dev)
        for name, fn in (("rank", lambda: cd.rank(d01)),
                         ("densify_rank",
                          lambda: cd.densify_rank(rank, d01, cv, k))):
            old_fn = under(cd, libs["ci_densify"], fn)
            same = bool(torch.equal(old_fn(), fn()))
            out[f"{name} K{k}"] = {**turns(old_fn, fn), "bit_equal": same}
            if not same:
                raise AssertionError(f"{name} differs from the older kernel "
                                     f"at K {k}")

    run = lambda: analyze_cohort(hp_d, mask_d, geom, cfg)
    with older_kernels(libs):
        old = run()
    same = all(torch.equal(getattr(old, f), getattr(res, f))
               for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"))
    times = []
    for older in (True, False, False, True):
        with older_kernels(libs) if older else contextlib.nullcontext():
            times.append(host_ms(run)[0])
    out["slice"] = {"parent_ms": (times[0] + times[3]) / 2,
                    "ms": (times[1] + times[2]) / 2, "turns": times,
                    "bit_identical": same}
    if not same:
        raise AssertionError("the slice on the older kernels differs")
    for k, v in out.items():
        log(f"parent {k}: " + json.dumps(v))
    with older_kernels(libs):
        phase_profile(cfg, geom, hp_d, mask_d, tag="_parent")
    return out


# The device kernel that each launch of a wrapper enqueues once (K2, K6 and
# K7 share theirs; K8 has two, one for each path; K9's older source enqueued
# rank_count and rank_write), for matching a profile's activities to the
# launch counts.
PROFILE_KERNELS = (
    (("moment_partial",), ("fit_moment",)),
    (("delta_kernel",), ("fit_delta_conv_field", "fit_delta",
                         "fit_delta_conv")),
    (("hist_partial",), ("sharpen_hist",)),
    (("resid_kernel",), ("sharpen_resid",)),
    (("head_counts_kernel",), ("head_counts",)),
    (("rank_scan", "rank_count"), ("rank",)),
    (("densify_vec16", "densify_scalar"), ("densify_rank",)),
    (("field_kernel",), ("n4_field",)),
)


def profiled_batch(cfg, geom, hp_d, mask_d, tries=6):
    """(profiler, device activities of one slice batch), from the first of
    two sessions in a row that are complete and agree.  The profiler can
    lose activities (see device_ms), so spin kernels go first and the last
    two spins mark the batch; a session is complete when the batch holds
    one activity of each wrapper's kernel for each launch the wrappers
    counted in it, and two complete sessions agree when they hold as many
    activities."""
    from torch.profiler import ProfilerActivity, profile

    from ventjax_torch.pipeline import analyze_cohort

    last, seen = None, []
    for _ in range(tries):
        reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                torch.cuda._sleep(1000)
            analyze_cohort(hp_d, mask_d, geom, cfg)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        counts = launch_counts()
        events = device_events(prof)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        events = events[marks[-2] + 1:marks[-1]] if len(marks) >= 2 else []
        complete = bool(events) and all(
            sum(any(m in e.name for m in names) for e in events)
            == sum(counts[k] for k in keys) for names, keys in PROFILE_KERNELS)
        if complete and last is not None and len(last[1]) == len(events):
            return prof, events
        last = (prof, events) if complete else None
        seen.append({"marks": len(marks), "activities": len(events),
                     "kernels": {keys[0]: [
                         sum(any(m in e.name for m in names) for e in events),
                         sum(counts[k] for k in keys)]
                         for names, keys in PROFILE_KERNELS}})
    raise RuntimeError(f"torch.profiler gave no two complete, agreeing "
                       f"sessions of a slice batch in {tries}: "
                       f"{json.dumps(seen)}")


def phase_profile(cfg, geom, hp_d, mask_d, tag=""):
    """One slice batch under torch.profiler (profiled_batch): device time by
    kernel and the device's busy share of the traced span, to chiprun_out/
    (tag names the kernels' sources in the log and the file)."""
    from pathlib import Path

    prof, events = profiled_batch(cfg, geom, hp_d, mask_d)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events)) if events else 0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    by_name = {}
    for e in events:
        name = e.name.split("namespace)::", 1)[-1].split("(")[0]
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e.time_range.elapsed_us())
    for label, names in (("K1", ("moment_partial", "reduce_chunks")),
                         ("K2", ("delta_kernel",)),
                         ("K3", ("head_counts_kernel",)),
                         ("K4", ("hist_partial", "hist_finish")),
                         ("K5", ("resid_kernel",)),
                         ("n4_field", ("field_kernel",))):
        log(f"profile{tag} {label}: " + "; ".join(
            f"{k} x{n} {us / 1e3:.4f} ms" for k, (n, us) in by_name.items()
            if any(m in k for m in names)))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"profile_slice{tag}.txt").write_text(table)
    log(f"profile{tag}: {len(events)} device kernels (every counted launch "
        f"present, as many as a repeat batch), {busy_us / 1e3:.2f} "
        f"ms device time in a {span_us / 1e3:.2f} ms span (busy share "
        f"{busy_us / max(span_us, 1):.3f}); table in "
        f"chiprun_out/profile_slice{tag}.txt")


KERNELS = {   # name: (source, the TPU kernel it replaces)
    "fit_moment": ("ventjax_torch/csrc/n4_fit.cu",
                   "ventjax/ops/n4_pallas.py:106"),
    "fit_delta_conv_field": ("ventjax_torch/csrc/n4_fit.cu",
                             "ventjax/ops/n4_pallas.py:422"),
    "fit_delta": ("ventjax_torch/csrc/n4_fit.cu",
                  "ventjax/ops/n4_pallas.py:148"),
    "fit_delta_conv": ("ventjax_torch/csrc/n4_fit.cu",
                       "ventjax/ops/n4_pallas.py:471"),
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
    # port-only: ventjax evaluates the dense field with an einsum outside
    # any kernel (no Pallas counterpart); "replaces" names that einsum
    "n4_field": ("ventjax_torch/csrc/n4_field.cu", "ventjax/ops/n4.py:500"),
}


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR", help=(
        "also build DIR/n4_fit.cu, DIR/n4_sharpen.cu, DIR/ci_head.cu and "
        "DIR/ci_densify.cu (an older version of the sources, with the same "
        "C interfaces) and time every kernel against them"))
    ap.add_argument("--rank", nargs=5, metavar=(
        "PORT", "RANK", "WORLD", "BACKEND", "DIR"), help=(
        "run one rank of path i's torch.distributed halo CI on DIR's volume "
        "(the libraries must be built) and nothing else"))
    args = ap.parse_args()
    if args.rank:
        return rank_main(*args.rank)
    dev, card = phase_device()
    phase_build()
    hp, mask, n4_pad = headline_cohort()
    max_err = phase_kernels(hp, mask, n4_pad, dev)
    cfg, geom, hp_d, mask_d, res, launches, syncs = phase_slice(
        hp, mask, n4_pad, dev)
    per_batch = dict(launches)
    launches.update(phase_densify(res, geom, cfg, dev))
    launches.update(phase_fit_chain(hp, mask, n4_pad, dev))
    phase_ladder(cfg, res, hp_d, mask_d)
    rate = phase_cohort(dev)
    serve_rate, arrival_s = phase_serve(dev)
    facade_launches, _, facade_err = phase_facade(dev)
    for k, e in facade_err.items():
        max_err[k] = max(max_err[k], e)
    seg_launches, _ = phase_segmentation(dev, card)
    dist_launches, dist_by_entry, _, k3_shard = phase_dist(
        dev, cfg, geom, hp_d, mask_d, res)
    mp_rates, mp_launches = phase_multiproc(dev)
    gui_launches, _ = phase_gui(dev)
    space_launches_l, space_by_entry, space_err, _ = phase_space(
        dev, cfg, geom, hp_d, mask_d, res)
    for k, e in space_err.items():
        max_err[k] = max(max_err[k], e)
    rank_launches, rank_err, _ = phase_ranks(dev, cfg, geom, hp, mask, hp_d,
                                             mask_d, res)
    for k, e in rank_err.items():
        max_err[k] = max(max_err[k], e)
    phase_doctor()
    med, rec = phase_timing(cfg, geom, hp_d, mask_d, res, hp, mask, n4_pad,
                            dev)
    rec["head_counts"]["path_i_shard"] = k3_shard
    if args.parent:
        phase_parent(args.parent, hp, mask, n4_pad, dev, res, geom, cfg,
                     hp_d, mask_d)
    phase_profile(cfg, geom, hp_d, mask_d)
    log(f"summary: card={card!r} slice_vol_per_s={BATCH * 1e3 / med:.3f} "
        f"cohort_subjects_per_s={rate:.3f} "
        f"serve_subjects_per_s={serve_rate:.3f} "
        f"serve_warm_arrival_s={arrival_s:.3f} n4_host_syncs={syncs} "
        f"multiproc_subjects_per_s="
        f"{json.dumps({k: round(v, 3) for k, v in mp_rates.items()})} "
        f"ci_max_defect_voxels={cfg.ci_max_defect_voxels} "
        f"n4_mask_pad={n4_pad}")
    log("launches per headline batch: " + json.dumps(per_batch))
    kernels = [{"name": k, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[k],
                "launches_per_batch": per_batch[k],
                "launches_path_g": facade_launches[k],
                "launches_path_h": seg_launches[k],
                "launches_path_i": dist_launches[k],
                "launches_path_i_by_entry": {
                    e: c[k] for e, c in dist_by_entry.items()},
                "launches_path_j": mp_launches[k],
                "launches_path_k": gui_launches[k],
                "launches_path_l": space_launches_l[k],
                "launches_path_m": rank_launches[k],
                "max_abs_err": max_err[k], **rec[k],
                "timed_by_events": events_timed(rec[k])}
               for k, (s, r) in KERNELS.items()]
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "ventjax")
                 or m.startswith(("jax.", "jaxlib.", "ventjax.")))
    if bad:
        raise AssertionError(f"the port loaded JAX or ventjax: {bad[:5]}")
    log("path l's split entry points (launches): "
        + json.dumps(space_by_entry))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
