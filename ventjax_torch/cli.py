"""Command line of the port: ``python -m ventjax_torch``.

The counterpart of ``ventjax/cli.py`` for the commands whose modules are
ported, with the same flags and the same JSON output, plus ``--device``:
every command runs on the CUDA card unless ``--device cpu`` is given, and
without a card it stops with an error (exit 2), never falling back to the
CPU.

Usage:
  python -m ventjax_torch analyze --xenon X.dcm (--mask MASKDIR |
      --proton P.dcm --auto-mask [--seg-ckpt C.npz] [--seg-base 16])
      --out OUT [--irb mepo --id 0039 --visit 1 --treatment preAlb]
      [--user RPT] [--no-ci] [--shard-slices N|auto] [--device cuda|cpu]
  python -m ventjax_torch train-seg --out DIR [--steps 200] [--batch 8]
      [--shape 128 128 16] [--base 16] [--seed 0] [--lr 1e-3]
      [--device cuda|cpu]
  python -m ventjax_torch export (--pickle S.pkl | --npz-in S.npz) --out OUT
      [--recalculate]
  python -m ventjax_torch twix --dat FILE.dat --out OUT
  python -m ventjax_torch cohort --manifest subjects.json --out OUT
      [--batch 16] [--mesh | --no-mesh] [--shard-export] [--dense-export]
      [--device cuda|cpu]
  torchrun --nproc_per_node 2 -m ventjax_torch cohort --manifest M --out OUT
      --mesh [--shard-export]
  python -m ventjax_torch serve --inbox IN --out OUT [--interval 5] [--once]
      [--mesh | --no-mesh]
  python -m ventjax_torch doctor [--full]
  python -m ventjax_torch gui [--xenon X.dcm] [--mask MASKDIR] [--out OUT]
      [--device cuda|cpu]
  python -m ventjax_torch info

``analyze`` and ``export`` write the report PNG, which needs Pillow: where
it is absent they stop before any analysis (exit 2) with a message that
names it.

``analyze --auto-mask`` predicts the lung mask from ``--proton`` with the
segmentation U-Net (the shipped ``ventjax_torch/models/seg_ckpt.npz``
unless ``--seg-ckpt`` names another), checks it with ``mask_qc`` after any
``--mask-edit`` and reports the verdict as ``automask_suspect`` and
``automask_qc`` (a warning, never a failure).  ``train-seg`` trains the
U-Net on one device and writes the port's ``.npz`` checkpoint,
``DIR/seg_ckpt.npz`` for ``--out DIR``.

``analyze --shard-slices N`` slice-shards the CI map over N local devices
of ``--device`` (``auto``: all of them; ``dist/halo.py``), bit-identical to
the one-device map; a geometry that cannot shard exits 2 saying why.
``cohort --mesh`` and ``serve --mesh`` split each batch over a batch mesh
of the cards ``--device`` names (``cuda``: every local card).  Unlike the
reference, one device is the default, and ``--no-mesh`` (the reference's
flag) says so: the mesh's shards run one after another, each costing about
a whole batch.

``cohort`` under torchrun (or any launcher that sets ``WORLD_SIZE`` above 1
with ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) joins a
torch.distributed group first: NCCL with one rank per card, gloo where the
device is the CPU or more ranks than cards share a machine.  Every rank runs
the same cohort; with ``--mesh`` each batch is split over the ranks, and
rank 0 writes every subject's files, or with ``--shard-export`` each rank
writes its own lanes (the ranks then need one shared filesystem).  Only rank
0 writes ``cohort_summary.json`` and the aggregate CSV.  Without those
variables it stays one process.

``gui`` opens the tkinter window of ``ventjax_torch.gui`` (the reference's
desktop app) with its analysis on ``--device``; without a display it exits
2 and says so.

``cohort --dense-export`` ships the dense N4 and defect volumes from the
card instead of the compact pack (``run_cohort(compact_export=False)``).
The reference CLI's ``--no-compile-cache`` is left out: the port has no
XLA cache to name (its nvcc libraries are cached by a hash of their
sources).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys


def _device_or_error(args):
    """The device asked for, or None after an error message (no card)."""
    from ventjax_torch.utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _pillow_or_error(what):
    """True where Pillow imports; else an error message naming it."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print(f"error: {what} writes a PNG report, which needs Pillow "
              "(PIL), and Pillow is not installed", file=sys.stderr)
        return False
    return True


def _jsonable(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


_SUMMARY_KEYS = ("SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume",
                 "DefectVolume", "CI")


def _auto_mask(args, device):
    """The lung mask the U-Net predicts from --proton, as a float32 numpy
    array, or None after an error message."""
    import numpy as np

    from ventjax_torch.io.dicom import open_single_dicom
    from ventjax_torch.models.segmentation import (
        default_checkpoint_path, load_checkpoint, predict_mask,
    )

    ckpt = args.seg_ckpt or default_checkpoint_path()
    if not os.path.exists(ckpt):
        print("error: --auto-mask needs --seg-ckpt (train one with "
              "`python -m ventjax_torch train-seg`); shipped artifact not "
              f"found at {ckpt}", file=sys.stderr)
        return None
    try:
        state = load_checkpoint(os.path.abspath(ckpt), device=device)
    except ValueError as e:
        print(f"error: --seg-ckpt {e}", file=sys.stderr)
        return None
    if state.model.base != args.seg_base:
        print(f"error: --seg-base {args.seg_base} does not match the "
              f"checkpoint {ckpt}, a U-Net of base {state.model.base}",
              file=sys.stderr)
        return None
    _, proton = open_single_dicom(args.proton)
    return predict_mask(state.model,
                        proton.astype(np.float32)).cpu().numpy()


def _cmd_analyze(args) -> int:
    from ventjax_torch.compat import Vent_Analysis
    from ventjax_torch.config import DEFAULT_CONFIG, preset
    from ventjax_torch.report.export import study_filename

    if args.mask is None and not args.auto_mask:
        print("error: provide --mask FOLDER or --auto-mask (with --seg-ckpt)",
              file=sys.stderr)
        return 2
    if args.auto_mask and args.proton is None:
        print("error: --auto-mask needs --proton", file=sys.stderr)
        return 2
    device = _device_or_error(args)
    if device is None or not _pillow_or_error("analyze"):
        return 2
    if args.deterministic:
        from ventjax_torch.utils.profiling import enable_deterministic

        enable_deterministic()

    study = None
    cfg = DEFAULT_CONFIG
    if args.irb:
        # Per-study schema: validates the treatment/visit arms against the
        # reference GUI's columns and supplies the study's VentConfig.
        study = preset(args.irb)
        study.validate(treatment=args.treatment, visit=args.visit)
        cfg = study.config
    if args.shard_slices:
        if args.shard_slices == "auto":
            from ventjax_torch.dist import mesh

            n_shards = len(mesh.local_devices(args.device))
        else:
            try:
                n_shards = int(args.shard_slices)
            except ValueError:
                print(f"error: --shard-slices must be an integer or 'auto', "
                      f"got {args.shard_slices!r}", file=sys.stderr)
                return 2
        cfg = cfg.replace(ci_shard_slices=n_shards)
    mask_array = None
    if args.auto_mask:
        mask_array = _auto_mask(args, device)
        if mask_array is None:
            return 2

    v = Vent_Analysis(
        xenon_path=args.xenon, mask_path=args.mask, proton_path=args.proton,
        mask_array=mask_array, config=cfg, device=device,
    )
    # Patient-info overrides: the GUI's edit buttons as flags.
    for flag, key in (
        (args.set_patient_name, "PatientName"),
        (args.set_age, "PatientAge"),
        (args.set_sex, "PatientSex"),
        (args.set_dob, "PatientBirthDate"),
        (args.set_study_date, "StudyDate"),
        (args.set_study_time, "StudyTime"),
        (args.disease, "Disease"),
    ):
        if flag is not None:
            v.metadata[key] = flag
    if args.mask_edit:
        # The reference's "edit mask" roadmap item as a scriptable recipe,
        # applied to hand-drawn and --auto-mask masks alike before any
        # analysis.
        try:
            v.editMask(args.mask_edit)
        except ValueError as e:
            print(f"error: --mask-edit {e}", file=sys.stderr)
            return 2
    if mask_array is not None:
        # Plausibility of the predicted mask: warn, never fail, and carry
        # the verdict in the exported metadata.  After --mask-edit, so it
        # describes the mask the metrics are computed from.
        import numpy as np

        from ventjax_torch.models.segmentation import mask_qc

        if not np.any(v.mask):
            # Nothing to analyse, and the report's crop needs a mask (the
            # reference package fails there with an IndexError).
            print("error: --auto-mask predicted an empty lung mask; nothing "
                  f"to analyze (checkpoint {args.seg_ckpt or 'shipped'})",
                  file=sys.stderr)
            return 2
        qc = mask_qc(np.asarray(v.mask), v.vox)
        v.metadata["automask_suspect"] = qc["suspect"]
        v.metadata["automask_qc"] = "; ".join(qc["reasons"])
        if qc["suspect"]:
            print("warning: auto-mask failed plausibility checks — "
                  + "; ".join(qc["reasons"])
                  + " — metrics below may be unreliable "
                  "(metadata.automask_suspect=true)", file=sys.stderr)
    if args.denoise is not None:
        # The reference's roadmap "Denoise Option", prototyped with Haar
        # wavelets in its playground script.
        import numpy as np
        import torch

        from ventjax_torch.ops.wavelet import denoise_volume

        v.HPvent = denoise_volume(
            torch.from_numpy(np.asarray(v.HPvent, np.float32)).to(device),
            args.denoise).cpu().numpy()
    v.calculate_VDP(thresh=args.thresh)
    if not args.no_ci:
        try:
            v.calculate_CI()
        except ValueError as e:
            # e.g. --shard-slices on a geometry the pairwise engine rejects,
            # or more shards than the halo or the devices allow
            print(f"error: {e}", file=sys.stderr)
            return 2
    v.metadata["analysisUser"] = args.user
    v.metadata["DE"] = args.de or ""
    v.metadata["FEV1"] = args.fev1 or ""
    v.metadata["FVC"] = args.fvc or ""
    v.metadata["notes"] = args.notes or ""
    if args.irb:
        v.metadata["IRB"] = args.irb
        v.metadata["treatment"] = args.treatment or "none"
        v.metadata["visit"] = args.visit or ""
        v.metadata[study.id_field] = args.id
        file_name = study_filename(
            args.irb, v.metadata,
            genxe_id=args.id, mepo_id=args.id, clinical_id=args.id,
            visit=args.visit, treatment=args.treatment,
        )
    else:
        file_name = args.filename or str(v.metadata["PatientName"]).replace(
            "^", "_")
    v.metadata["fileName"] = file_name

    os.makedirs(args.out, exist_ok=True)
    v.exportNifti(args.out, file_name)
    v.dicom_to_json(v.ds, os.path.join(args.out, f"{file_name}.json"))
    v.pickleMe(os.path.join(args.out, f"{file_name}.pkl"))
    if args.npz:
        v.saveNpz(os.path.join(args.out, f"{file_name}.npz"))
    v.screenShot(os.path.join(args.out, f"{file_name}.png"))
    if args.histogram:
        v.exportHistogram(os.path.join(args.out, f"{file_name}_hist.png"))
    v.exportDICOM(v.ds, args.out, optional_text=file_name, forPACS=True,
                  compress=args.compress_dicom)
    if args.archive:
        os.makedirs(args.archive, exist_ok=True)
        v.pickleMe(os.path.join(args.archive, f"{file_name}.pkl"))

    out = {k: _jsonable(v.metadata[k]) for k in _SUMMARY_KEYS}
    if "automask_suspect" in v.metadata:
        out["automask_suspect"] = bool(v.metadata["automask_suspect"])
        out["automask_qc"] = str(v.metadata["automask_qc"])
    print(json.dumps(out, indent=2))
    return 0


def _cmd_train_seg(args) -> int:
    """Train the proton->mask U-Net on synthetic phantoms (host data,
    device steps) and save an .npz checkpoint usable by analyze
    --auto-mask."""
    import torch

    from ventjax_torch.io.phantom import make_cohort, make_random_cohort
    from ventjax_torch.models.segmentation import (
        create_train_state, save_checkpoint, train_step,
    )

    device = _device_or_error(args)
    if device is None:
        return 2
    shape = tuple(args.shape)
    try:
        state = create_train_state(
            torch.Generator().manual_seed(args.seed), shape=shape[:2],
            base=args.base, learning_rate=args.lr, device=device)
    except ValueError as e:
        print(f"error: --shape {e}", file=sys.stderr)
        return 2
    loss = float("nan")
    for i in range(args.steps):
        # Domain-randomized phantoms (geometry/contrast/noise/bias/partial-
        # volume edges vary per sample) so the checkpoint generalizes past
        # one generator configuration; --plain-phantoms restores the
        # fixed-generator behavior.
        if args.plain_phantoms:
            _, mask, proton = make_cohort(
                args.batch, shape=shape, seed=args.seed + 1 + i)
        else:
            _, mask, proton = make_random_cohort(
                args.batch, shape=shape, seed=args.seed + 1 + i * args.batch)
        loss_t = train_step(state, proton, mask)
        if (i + 1) % 25 == 0 or i == 0:
            loss = float(loss_t)
            print(f"step {i + 1}/{args.steps}: loss {loss:.4f}", flush=True)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    path = save_checkpoint(out, state, params_only=args.params_only)
    print(json.dumps({"checkpoint": path, "steps": args.steps,
                      "final_loss": loss}))
    return 0


def _cmd_export(args) -> int:
    """Regenerate report exports from a saved study artifact.

    The reference GUI's 'Load Pickle' button followed by 'Export', as one
    command over either checkpoint format (pickle or the versioned NPZ).
    `--recalculate` reruns the analysis on the stored arrays first, so an
    archived study can be re-analyzed (e.g. a new --thresh) without the
    raw DICOMs.
    """
    import pickle

    import numpy as np

    from ventjax_torch.compat import Vent_Analysis
    from ventjax_torch.report.export import ReferencePickleError

    device = _device_or_error(args)
    if device is None:
        return 2
    src = args.pickle or args.npz_in
    try:
        if args.pickle:
            v = Vent_Analysis(pickle_path=args.pickle, device=device)
        else:
            v = Vent_Analysis(npz_path=args.npz_in, device=device)
    except (ReferencePickleError, ValueError, OSError, EOFError,
            pickle.UnpicklingError) as e:
        # a missing, truncated or corrupt file is a user-input problem
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not hasattr(v, "HPvent") or not hasattr(v, "mask"):
        print(f"error: {src} holds no HPvent/mask arrays; nothing to export",
              file=sys.stderr)
        return 2
    analyzed = not (isinstance(v.defectArray, str)
                    or isinstance(v.N4HPvent, str))
    if (analyzed or args.recalculate) and not _pillow_or_error("export"):
        return 2
    # Slim artifacts (cohort NPZs) carry only the analysis arrays; derived
    # display state is recomputed, not required.
    if not hasattr(v, "mask_border"):
        v.mask_border = v.calculateBorder(np.asarray(v.mask))
    if args.recalculate:
        v.calculate_VDP(thresh=args.thresh)
        if not args.no_ci:
            v.calculate_CI()
        analyzed = True

    file_name = (args.filename or str(v.metadata.get("fileName") or "")
                 or os.path.splitext(os.path.basename(src))[0])
    os.makedirs(args.out, exist_ok=True)
    written, skipped = [], []
    written.append(v.exportNifti(args.out, file_name))
    v.pickleMe(os.path.join(args.out, f"{file_name}.pkl"))
    written.append(os.path.join(args.out, f"{file_name}.pkl"))
    if args.npz:
        written.append(v.saveNpz(os.path.join(args.out, f"{file_name}.npz")))
    if not isinstance(v.ds, str):
        jpath = os.path.join(args.out, f"{file_name}.json")
        v.dicom_to_json(v.ds, jpath)
        written.append(jpath)
    else:
        skipped.append("header JSON (artifact carries no DICOM dataset)")
    if analyzed:
        ppath = os.path.join(args.out, f"{file_name}.png")
        v.screenShot(ppath)
        written.append(ppath)
        if args.histogram:
            hpath = os.path.join(args.out, f"{file_name}_hist.png")
            v.exportHistogram(hpath)
            written.append(hpath)
        if not isinstance(v.ds, str):
            written.append(v.exportDICOM(
                v.ds, args.out, optional_text=file_name, forPACS=True,
                compress=args.compress_dicom))
        else:
            skipped.append("defect DICOMs (artifact carries no DICOM dataset)")
    else:
        skipped.append("screenshot + defect DICOMs (artifact not analyzed; "
                       "use --recalculate)")
    summary = {k: _jsonable(v.metadata.get(k, "")) for k in _SUMMARY_KEYS}
    print(json.dumps({"written": written, "skipped": skipped,
                      "metrics": summary}, indent=2))
    return 0


def _cmd_twix(args) -> int:
    import numpy as np

    from ventjax_torch.io.twix import read_twix
    from ventjax_torch.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss,
    )

    device = _device_or_error(args)
    if device is None:
        return 2
    tw = read_twix(args.dat)
    if tw.n_channels > 1:
        k = tw.kspace_multicoil()
        img = recon_2d_multislice_rss(k, device=device)
        combine = "rss"
    else:
        k = tw.kspace()
        img = recon_2d_multislice(k, device=device)
        combine = "none"
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "raw_HPvent.npy"), img)
    print(json.dumps({
        "protocol": tw.protocol_name,
        "scan_datetime": tw.scan_datetime,
        "header_params": tw.header_params,
        "kspace_shape": list(k.shape),
        "channels": tw.n_channels,
        "coil_combine": combine,
        "out": os.path.join(args.out, "raw_HPvent.npy"),
    }))
    return 0


def _config(args):
    from ventjax_torch.config import DEFAULT_CONFIG

    if args.deterministic:
        from ventjax_torch.utils.profiling import enable_deterministic

        enable_deterministic()
    cfg = DEFAULT_CONFIG
    if args.max_defect:
        cfg = cfg.replace(ci_max_defect_voxels=args.max_defect)
    return cfg


def _join_ranks(device) -> bool:
    """Join the torch.distributed group that torchrun's environment names
    (``WORLD_SIZE`` above 1, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    False, doing nothing, where it names one process.  NCCL with one rank
    per card; gloo on the CPU or where more ranks than cards share this
    machine (``LOCAL_WORLD_SIZE``), since NCCL refuses two ranks on one
    card."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    import torch

    from ventjax_torch.dist import initialize_multihost

    env = os.environ
    addr = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            if "MASTER_ADDR" in env and "MASTER_PORT" in env else None)
    local = int(env.get("LOCAL_WORLD_SIZE", world))
    gloo = device.type != "cuda" or local > torch.cuda.device_count()
    initialize_multihost(addr, world, int(env["RANK"]) if "RANK" in env
                         else None, backend="gloo" if gloo else None)
    return True


def _cmd_cohort(args) -> int:
    device = _device_or_error(args)
    if device is None:
        return 2
    try:
        joined = _join_ranks(device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        return _run_cohort_command(args)
    finally:
        if joined:
            import torch.distributed as tdist

            tdist.destroy_process_group()


def _run_cohort_command(args) -> int:
    from ventjax_torch.pipeline.cohort import load_manifest, run_cohort
    from ventjax_torch.utils.profiling import trace

    cfg = _config(args)
    manifest = load_manifest(args.manifest)
    watchdog = contextlib.nullcontext()
    if args.stall_timeout > 0:
        from ventjax_torch.utils.watchdog import StallWatchdog

        watchdog = StallWatchdog(args.stall_timeout, label="cohort")
    progress = None
    if args.progress or args.stall_timeout > 0:
        # One JSON line per progress event on stderr (stdout stays the
        # machine-readable result) — tail-able for long cohorts.  The
        # same events feed the stall watchdog when one is armed.
        def progress(stage, done, total):
            if args.stall_timeout > 0:
                watchdog.touch()
            if args.progress:
                print(json.dumps({"stage": stage, "done": done,
                                  "total": total}),
                      file=sys.stderr, flush=True)
    with trace(args.profile_dir), watchdog:
        results = run_cohort(
            manifest, args.out, config=cfg, batch_size=args.batch,
            resume=not args.fresh, export_npz=args.npz, progress=progress,
            device=args.device, use_mesh=args.mesh,
            shard_export=args.shard_export,
            compact_export=not args.dense_export,
        )
    ok = sum(1 for r in results if r.get("valid"))
    print(json.dumps({"subjects": len(results), "valid": ok,
                      "out": args.out}))
    # The aggregate files go to one shared path: with several ranks only
    # rank 0 writes them (every rank holds the same results).
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_rank() != 0:
        return 0
    # cohort-level aggregate summary: distribution stats per metric plus an
    # explicit accounting of failed / flagged lanes (pipeline.summary)
    from ventjax_torch.pipeline.summary import cohort_summary

    with open(os.path.join(args.out, "cohort_summary.json"), "w") as f:
        json.dump(cohort_summary(results), f, indent=2)
    # cohort-level CSV (+ parquet when pyarrow exists) aggregation
    import csv
    keys = sorted({k for r in results for k in r})
    with open(os.path.join(args.out, "cohort_metrics.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(results)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        pass
    else:
        # one typed column per key; heterogenous cells (a metric on one
        # subject, an error string on another) degrade that column to string
        cols = {}
        for k in keys:
            vals = [r.get(k) for r in results]
            if all(v is None or isinstance(v, (int, float, bool))
                   for v in vals):
                cols[k] = vals
            else:
                cols[k] = [None if v is None else str(v) for v in vals]
        pq.write_table(pa.table(cols),
                       os.path.join(args.out, "cohort_metrics.parquet"))
    return 0


def _cmd_gui(args) -> int:
    from ventjax_torch.gui.app import GuiUnavailableError, launch
    from ventjax_torch.gui.controller import GuiState, VentController

    state = GuiState(
        dicom_path=args.xenon or "", mask_path=args.mask or "",
        proton_path=args.proton or "", twix_path=args.twix or "",
        export_path=args.out or "", archive_path=args.archive or "",
        user=args.user or "",
    )
    try:
        launch(VentController(state, device=args.device))
    except GuiUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def parse_geometry_spec(spec: str):
    """Parse a --prewarm geometry spec ``HxWxD[@vr,vc,vs]`` into
    ((H, W, D), (vr, vc, vs)); vox defaults to the common clinical
    (1.5, 1.5, 10.0) mm when omitted."""
    shape_s, _, vox_s = spec.partition("@")
    try:
        shape = tuple(int(x) for x in shape_s.lower().split("x"))
        vox = ((1.5, 1.5, 10.0) if not vox_s
               else tuple(float(x) for x in vox_s.split(",")))
    except ValueError:
        raise ValueError(f"bad geometry spec {spec!r}: expected "
                         "HxWxD[@vr,vc,vs], e.g. 128x128x16@1.5,1.5,10.0")
    # all(v > 0) is False for NaN too (NaN comparisons are all False),
    # unlike a min(vox) <= 0 test, which NaN would sneak past.
    if len(shape) != 3 or len(vox) != 3 or not all(d >= 1 for d in shape) \
            or not all(math.isfinite(v) and v > 0 for v in vox):
        raise ValueError(f"bad geometry spec {spec!r}: need three positive "
                         "dims and three positive finite voxel sizes")
    return shape, vox


def _cmd_serve(args) -> int:
    import signal
    import threading

    from ventjax_torch.pipeline.serve import WatchService

    device = _device_or_error(args)
    if device is None:
        return 2
    cfg = _config(args)
    svc = WatchService(
        args.inbox, args.out, config=cfg, batch_size=args.batch,
        ready_marker=args.ready_marker, min_age=args.min_age,
        max_retries=args.max_retries, retry_backoff=args.retry_backoff,
        settle_scans=args.settle_scans, export_npz=args.npz,
        device=args.device, use_mesh=args.mesh,
    )

    # Validate --prewarm specs FIRST: pure string parsing must fail fast,
    # not after the preflight battery.
    geoms = []
    if args.prewarm:
        try:
            geoms = [parse_geometry_spec(s) for s in args.prewarm]
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    # The startup phases (doctor device probe and kernel build, prewarm)
    # hit the device before serve_forever arms its per-scan watchdog, and a
    # wedged device is a startup hazard too.  Reuse --scan-timeout as a
    # per-phase stall budget: preflight completion and every prewarm
    # progress event feed it.
    if args.scan_timeout > 0 and (args.preflight or geoms):
        from ventjax_torch.utils.watchdog import StallWatchdog

        startup_wd = StallWatchdog(args.scan_timeout,
                                   label="serve startup")
    else:
        startup_wd = None

    with (startup_wd or contextlib.nullcontext()):
        if args.preflight:
            # Refuse to serve on a broken install: run the doctor battery
            # before the first scan.  The result (pass or fail) also lands
            # in the serve_status.json heartbeat for monitors.
            from ventjax_torch.utils.doctor import format_report

            report = svc.preflight()
            if not report["ok"]:
                print(format_report(report), file=sys.stderr)
                print("error: preflight failed; not serving",
                      file=sys.stderr)
                return 2
            if startup_wd is not None:
                startup_wd.touch()

        if geoms:
            secs = svc.prewarm(
                geoms,
                progress=(None if startup_wd is None
                          else lambda *a: startup_wd.touch()),
            )
            print(json.dumps({"prewarmed": len(geoms),
                              "seconds": round(secs, 1)}), file=sys.stderr)

    last_pending = [None]

    def on_scan(report):
        # One JSON line per scan — machine-tailable service output.  Print
        # whenever the scan did work (incl. retries, which have new=0) or
        # the pending count changed; a permanently non-conforming inbox
        # entry thus prints once, not every interval.  --verbose prints
        # every scan.
        did_work = (report.new or report.retried or report.resumed
                    or report.analyzed or report.failed)
        pending_changed = report.pending != last_pending[0]
        last_pending[0] = report.pending
        if did_work or pending_changed or args.verbose:
            print(json.dumps(report.as_dict()), flush=True)

    if args.once:
        report = svc.scan_once()
        print(json.dumps(report.as_dict()))
        return 0 if report.failed == 0 else 1
    stop = threading.Event()
    # Graceful shutdown under process supervisors (systemd, docker stop):
    # SIGTERM finishes the in-flight scan, then exits the loop cleanly so
    # the last subject's export + .done marker are never torn.
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (embedded use); SIGTERM stays default
    try:
        svc.serve_forever(interval=args.interval, stop=stop,
                          max_scans=args.max_scans, on_scan=on_scan,
                          scan_timeout=args.scan_timeout)
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_doctor(args) -> int:
    from ventjax_torch.utils.doctor import format_report, run_doctor

    report = run_doctor(full=args.full, device=args.device)
    print(format_report(report))
    return 0 if report["ok"] else 1


def _cmd_info(args) -> int:
    import dataclasses

    import torch

    import ventjax_torch
    from ventjax_torch.config import DEFAULT_CONFIG

    devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
               for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    print(json.dumps({
        "ventjax_torch": ventjax_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": devices,
        "default_config": dataclasses.asdict(DEFAULT_CONFIG),
    }, indent=2))
    return 0


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                   "'cpu' runs the plain versions of the kernels on the "
                   "CPU)")


def _add_mesh(p):
    g = p.add_mutually_exclusive_group()
    g.add_argument("--mesh", action="store_true",
                   help="split each batch over a batch mesh of the cards "
                   "--device names ('cuda': every local card)")
    g.add_argument("--no-mesh", action="store_true",
                   help="one device (the default here; the reference's "
                   "flag)")


def build_parser() -> argparse.ArgumentParser:
    """The argument parser (split from main so tests and docs can
    introspect the subcommand surface without invoking anything)."""
    p = argparse.ArgumentParser(prog="ventjax_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="analyze one study and export reports")
    a.add_argument("--xenon", required=True)
    a.add_argument("--mask", default=None)
    a.add_argument("--proton", default=None)
    a.add_argument("--out", required=True)
    a.add_argument("--thresh", type=float, default=0.6)
    a.add_argument("--no-ci", action="store_true")
    a.add_argument("--user", default="")
    a.add_argument("--irb", choices=["genxe", "mepo", "clinical"], default=None)
    a.add_argument("--id", default="0000")
    a.add_argument("--visit", default=None)
    a.add_argument("--treatment", default=None)
    a.add_argument("--de", default=None)
    a.add_argument("--fev1", default=None)
    a.add_argument("--fvc", default=None)
    a.add_argument("--notes", default=None)
    a.add_argument("--disease", default=None,
                   help="Disease metadata (GUI radio)")
    a.add_argument("--set-patient-name", default=None,
                   help="override PatientName (GUI edit button)")
    a.add_argument("--set-age", default=None, help="override PatientAge")
    a.add_argument("--set-sex", default=None, help="override PatientSex")
    a.add_argument("--set-dob", default=None, help="override PatientBirthDate")
    a.add_argument("--set-study-date", default=None, help="override StudyDate")
    a.add_argument("--set-study-time", default=None, help="override StudyTime")
    a.add_argument("--auto-mask", action="store_true",
                   help="predict the lung mask from --proton with the U-Net "
                   "(no --mask folder needed)")
    a.add_argument("--seg-ckpt", default=None,
                   help=".npz checkpoint (or a directory holding "
                   "seg_ckpt.npz) for --auto-mask (see train-seg)")
    a.add_argument("--seg-base", type=int, default=16,
                   help="U-Net base width the checkpoint was trained with")
    a.add_argument("--deterministic", action="store_true",
                   help="TF32 off and deterministic cuDNN")
    a.add_argument("--filename", default=None)
    a.add_argument("--archive", default=None,
                   help="optional second pickle copy (the GUI's archive box)")
    a.add_argument("--max-defect", type=int, default=None,
                   help="accepted for compatibility with the reference CLI "
                   "and ignored: the CI pad is sized from each study's "
                   "defect count")
    a.add_argument("--histogram", action="store_true",
                   help="also export the masked-signal histogram with the "
                   "linear-binning edges ({file}_hist.png)")
    a.add_argument("--mask-edit", default=None, metavar="RECIPE",
                   help="morphology recipe applied to the mask before "
                   "analysis, e.g. 'close:1,fillholes,erode:1' (ops: "
                   "dilate/erode/open/close[:iters], fillholes)")
    a.add_argument("--compress-dicom", action="store_true",
                   help="write the defect-overlay DICOMs RLE Lossless "
                   "compressed (PS3.5 Annex G) instead of Explicit VR LE")
    a.add_argument("--npz", action="store_true",
                   help="also export the versioned NPZ study artifact "
                   "(pickle-free; loads anywhere NumPy exists)")
    a.add_argument("--denoise", type=float, default=None, metavar="THRESH",
                   help="Haar-wavelet denoise the xenon volume first")
    a.add_argument("--shard-slices", default=None, metavar="N|auto",
                   help="oversize volumes: shard the CI slice axis over N "
                   "local devices of --device ('auto' = all of them) by "
                   "halo exchange, bit-identical to unsharded (requires the "
                   "pairwise CI engine)")
    _add_device(a)
    a.set_defaults(fn=_cmd_analyze)

    e = sub.add_parser(
        "export",
        help="regenerate report exports from a saved study artifact "
        "(pickle or NPZ) — the GUI's Load-Pickle + Export workflow",
    )
    esrc = e.add_mutually_exclusive_group(required=True)
    esrc.add_argument("--pickle", default=None, metavar="STUDY.pkl",
                      help="study pickle (pickleMe / analyze output; the "
                      "reference package's pickles load too)")
    esrc.add_argument("--npz-in", default=None, metavar="STUDY.npz",
                      help="versioned NPZ study artifact (saveNpz / "
                      "analyze --npz / cohort --npz output)")
    e.add_argument("--out", required=True)
    e.add_argument("--filename", default=None,
                   help="output basename (default: the artifact's stored "
                   "fileName, else the input file's stem)")
    e.add_argument("--recalculate", action="store_true",
                   help="rerun VDP (+CI) on the stored arrays before "
                   "exporting — re-analyze without the raw DICOMs")
    e.add_argument("--thresh", type=float, default=0.6,
                   help="mean-anchored defect threshold for --recalculate")
    e.add_argument("--no-ci", action="store_true",
                   help="skip CI during --recalculate")
    e.add_argument("--histogram", action="store_true",
                   help="also export the masked-signal histogram")
    e.add_argument("--compress-dicom", action="store_true",
                   help="RLE Lossless defect-overlay DICOMs")
    e.add_argument("--npz", action="store_true",
                   help="also (re)write the versioned NPZ artifact")
    _add_device(e)
    e.set_defaults(fn=_cmd_export)

    ts = sub.add_parser(
        "train-seg",
        help="train the proton->mask U-Net on synthetic phantoms and save "
        "an .npz checkpoint for analyze --auto-mask",
    )
    ts.add_argument("--out", required=True,
                    help="checkpoint directory (gets seg_ckpt.npz)")
    ts.add_argument("--steps", type=int, default=200)
    ts.add_argument("--batch", type=int, default=8)
    ts.add_argument("--shape", type=int, nargs=3, default=(128, 128, 16))
    ts.add_argument("--base", type=int, default=16)
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--lr", type=float, default=1e-3)
    ts.add_argument("--params-only", action="store_true",
                    help="save an inference-only checkpoint (no optimizer "
                    "state; the shipped-artifact form)")
    ts.add_argument("--plain-phantoms", action="store_true",
                    help="train on the fixed-generator phantoms instead of "
                    "the domain-randomized ones")
    _add_device(ts)
    ts.set_defaults(fn=_cmd_train_seg)

    t = sub.add_parser("twix", help="reconstruct a Siemens twix .dat")
    t.add_argument("--dat", required=True)
    t.add_argument("--out", required=True)
    _add_device(t)
    t.set_defaults(fn=_cmd_twix)

    c = sub.add_parser("cohort", help="batched cohort run from a manifest")
    c.add_argument("--manifest", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--batch", type=int, default=None)
    _add_mesh(c)
    c.add_argument("--fresh", action="store_true", help="ignore done-markers")
    c.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome / Perfetto "
                   "JSON) of the run into this directory")
    c.add_argument("--npz", action="store_true",
                   help="also write each subject's versioned NPZ artifact")
    c.add_argument("--dense-export", action="store_true",
                   help="ship the dense N4 and defect volumes from the "
                   "device instead of the compact pack (N4's masked "
                   "values, the B-spline lattices and the defect indices; "
                   "the default, the dense pack's bits at every analysed "
                   "voxel)")
    c.add_argument("--shard-export", action="store_true",
                   help="several ranks (torchrun): each rank exports its "
                   "own batch lanes (shared filesystem required) instead "
                   "of rank 0 exporting everything; needs --mesh")
    c.add_argument("--progress", action="store_true",
                   help="emit JSON progress events (decode/analyze/"
                   "export) on stderr as the cohort streams")
    c.add_argument("--stall-timeout", type=float, default=0.0,
                   help="watchdog: hard-exit (code 86) if no decode/"
                   "analyze/export progress for this many seconds — "
                   "recovers a wedged device under a job scheduler (rerun "
                   "resumes from .done markers); size it above the "
                   "worst-case gap incl. the first kernel build; 0 "
                   "disables")
    c.add_argument("--max-defect", type=int, default=None,
                   help="static bound on defect voxels for CI (default 8192)")
    c.add_argument("--deterministic", action="store_true",
                   help="TF32 off and deterministic cuDNN")
    _add_device(c)
    c.set_defaults(fn=_cmd_cohort)

    s = sub.add_parser(
        "serve",
        help="watch an inbox directory and analyze studies as they arrive "
        "(warm runners across scans; exactly-once via .done markers)",
    )
    s.add_argument("--inbox", required=True,
                   help="directory to watch; each subdirectory holding "
                   "xenon.dcm + mask/ (optional proton.dcm) is a subject")
    s.add_argument("--out", required=True, help="output root (one "
                   "subdirectory per subject id + serve_log.jsonl)")
    s.add_argument("--interval", type=float, default=5.0,
                   help="seconds between inbox scans")
    s.add_argument("--once", action="store_true",
                   help="single scan, then exit (exit 1 if any new subject "
                   "failed)")
    s.add_argument("--max-scans", type=int, default=None,
                   help="stop after N scans (default: run until SIGINT)")
    s.add_argument("--ready-marker", default=None, metavar="NAME",
                   help="only pick up a subject once NAME exists in its "
                   "directory (producer drops it after the copy completes)")
    s.add_argument("--min-age", type=float, default=1.0,
                   help="without --ready-marker: require the subject's "
                   "newest file mtime to be at least this many seconds old "
                   "before pickup (guards half-copied studies)")
    s.add_argument("--max-retries", type=int, default=2,
                   help="re-attempt a failed subject up to N times with "
                   "exponential backoff; after that it waits until its "
                   "files change on disk (which re-arms a fresh budget)")
    s.add_argument("--retry-backoff", type=float, default=60.0,
                   help="base seconds before the first retry of a failed "
                   "subject (doubles on each further attempt)")
    s.add_argument("--prewarm", action="append", default=[],
                   metavar="HxWxD[@vr,vc,vs]",
                   help="warm the pipeline for this study geometry before "
                   "serving (repeatable), so the first real arrival skips "
                   "the kernel and geometry builds; vox defaults to "
                   "1.5,1.5,10.0 mm, e.g. --prewarm 128x128x16@1.5,1.5,10.0")
    s.add_argument("--scan-timeout", type=float, default=0.0,
                   help="watchdog: hard-exit (code 86) if one scan runs "
                   "longer than this many seconds — recovers a wedged "
                   "device under a process supervisor (systemd Restart=, "
                   "docker --restart); also budgets each startup phase "
                   "(--preflight battery, each --prewarm step); 0 disables "
                   "(ignored with --once except for the startup phases)")
    s.add_argument("--preflight", action="store_true",
                   help="run the doctor check battery before serving; "
                   "exit 2 without scanning if a required check fails "
                   "(result recorded in serve_status.json)")
    s.add_argument("--settle-scans", type=int, default=0,
                   help="require a subject's file signature to be stable "
                   "across N consecutive scans before first pickup — use "
                   "N>=1 for producers that preserve source mtimes "
                   "(rsync -a), which defeat the --min-age test")
    s.add_argument("--npz", action="store_true",
                   help="also write each subject's versioned NPZ artifact")
    s.add_argument("--batch", type=int, default=None)
    _add_mesh(s)
    s.add_argument("--max-defect", type=int, default=None,
                   help="static bound on defect voxels for CI (default 8192)")
    s.add_argument("--deterministic", action="store_true",
                   help="TF32 off and deterministic cuDNN")
    s.add_argument("--verbose", action="store_true",
                   help="print a JSON line for quiet scans too")
    _add_device(s)
    s.set_defaults(fn=_cmd_serve)

    g = sub.add_parser(
        "gui", help="desktop GUI (tkinter port of the reference app)")
    g.add_argument("--xenon", default=None, help="prefill the DICOM path")
    g.add_argument("--mask", default=None, help="prefill the mask folder")
    g.add_argument("--proton", default=None)
    g.add_argument("--twix", default=None)
    g.add_argument("--out", default=None, help="prefill the export path")
    g.add_argument("--archive", default=None, help="archive pickle dir")
    g.add_argument("--user", default=None)
    _add_device(g)
    g.set_defaults(fn=_cmd_gui)

    d = sub.add_parser(
        "doctor",
        help="deployment self-check: device probe, kernel build, codec "
        "round-trip, pipeline-vs-oracle self-test; exit 0 iff healthy",
    )
    d.add_argument("--full", action="store_true",
                   help="flagship-geometry self-test incl. CI (slower; "
                   "times the device path)")
    _add_device(d)
    d.set_defaults(fn=_cmd_doctor)

    i = sub.add_parser("info", help="version / device info")
    i.set_defaults(fn=_cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.environ.get("VENTJAX_DEBUG_STACKS"):
        # Hang forensics: dump every thread's Python stack to stderr every
        # 120 s so a stuck run shows where it is stuck.
        import faulthandler

        faulthandler.dump_traceback_later(120, repeat=True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
