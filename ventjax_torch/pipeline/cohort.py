"""Cohort driver: streaming, batched, resumable multi-subject runs.

Counterpart of ``ventjax/pipeline/cohort.py``, in one process: on the card
unless the caller asks for the CPU (``device="cpu"``), and, when asked
(``use_mesh``), on a batch mesh over every local card where there are
several (``dist/mesh.py``):

- a manifest (JSON list of {"id", "xenon", "mask", "proton"?}) names the
  cohort;
- subjects are decoded on the host by a thread pool through a bounded
  prefetch window, so host memory is O(batch), not O(cohort);
- subjects are grouped by geometry (shape, voxel size) and analysed in
  per-geometry batches by ``analyze_cohort`` (mixed-geometry manifests
  work, and each geometry gets its own CI engine from ``build_geometry``);
- the CI defect pad and the N4 mask pad start small and grow (powers of
  two, sticky per geometry) when a batch overflows; the batch is then
  re-run, so results are never silently truncated.  The configured values
  are the ceilings, beyond which the overflow flags stand;
- per-subject outputs (6-channel NIfTI, metrics JSON, DICOM header JSON,
  optional NPZ) are written by a small thread pool, at most two batches
  behind the device, with a ``.done`` marker written last, so a rerun
  skips completed subjects;
- a subject that does not decode, or has an empty mask, fails alone.

The device-to-host pack is dense: the N4 image in float32, the defect map
in uint8, and the CI values at the defect compaction with their count
(``_densify_ci`` rebuilds the map).  ventjax's compact pack is not
ported; its multi-process driver (process-0 export, ``shard_export``, the
broadcast of the done flags) waits for a later slice.

Decoding and exports go through the port's own ``ventjax_torch.io.dicom``,
``ventjax_torch.io.native`` and ``ventjax_torch.report.export``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ventjax_torch.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.dist import mesh as dmesh
from ventjax_torch.io import dicom as dcm
from ventjax_torch.ops.basic import compact_mask_indices
from ventjax_torch.ops.ci_pairwise import CIPairwiseGeometry
from ventjax_torch.pipeline.analyze import analyze_cohort, build_geometry
from ventjax_torch.pipeline.result import StudyMetrics
from ventjax_torch.report import export as rexport
from ventjax_torch.utils.device import resolve_device

log = logging.getLogger("ventjax_torch.cohort")


def load_manifest(path: str) -> List[Dict]:
    with open(path) as f:
        subjects = json.load(f)
    if not isinstance(subjects, list):
        raise ValueError("manifest must be a JSON list of subject dicts")
    for i, e in enumerate(subjects):
        if not isinstance(e, dict):
            raise ValueError(f"manifest entry {i} is not a dict")
        missing = [k for k in ("id", "xenon", "mask") if k not in e]
        if missing:
            raise ValueError(
                f"manifest entry {i} is missing required key(s) "
                f"{missing}; each entry needs "
                '{"id", "xenon", "mask"} (optional "proton")')
        if not isinstance(e["id"], str) or not e["id"]:
            raise ValueError(
                f"manifest entry {i}: \"id\" must be a non-empty string "
                f"(got {e['id']!r}); it names the subject's output "
                "directory")
    ids = [e["id"] for e in subjects]
    if len(set(ids)) != len(ids):
        dupes = sorted({s for s in ids if ids.count(s) > 1})
        raise ValueError(
            f"manifest has duplicate subject id(s) {dupes}; ids name the "
            "per-subject output directories and must be unique")
    return subjects


def _decode_mask_folder_fast(folder: str) -> Optional[np.ndarray]:
    """Native per-slice decode of the mask folder; None -> fall back to the
    Python codec."""
    from ventjax_torch.io import native

    if not native.available():
        return None
    files = [f for f in sorted(os.listdir(folder)) if f.endswith(".dcm")]
    if not files:
        return None
    slices = []
    for fname in files:
        r = native.decode_pixels(os.path.join(folder, fname))
        if r is None:
            return None
        slices.append(r[0])
    return np.stack(slices, axis=-1).astype(np.float64)


def _decode_subject(entry: Dict) -> Tuple[Optional[np.ndarray], ...]:
    """Host-side DICOM decode of one subject; None signals a decode error.

    Returns (hp, mask, vox, ds, proton); proton is None unless the manifest
    entry names one (it feeds the NIfTI channel 0, not the analysis).
    DICOM pixel data is integral, so hp is kept as uint16 and the mask as
    uint8 where that is exact (half the host memory of the prefetch
    window); anything else stays float32."""
    try:
        ds, hp = dcm.open_single_dicom(entry["xenon"])
        mask = _decode_mask_folder_fast(entry["mask"])
        if mask is None:
            _, mask = dcm.open_dicom_folder(entry["mask"])
        proton = None
        if entry.get("proton"):
            _, proton = dcm.open_single_dicom(entry["proton"])
            proton = proton.astype(np.float32)
        vox = None
        for k in range(100):
            try:
                vox = list(ds[(0x5200, 0x9230)][k]["PixelMeasuresSequence"][0]
                           .PixelSpacing)
                break
            except Exception:
                continue
        if vox is None and "PixelSpacing" in ds:
            vox = list(ds.PixelSpacing)
        vox = [float(vox[0]), float(vox[1]), float(ds.SpacingBetweenSlices)]
        hp = hp.astype(np.float32)
        u16 = hp.astype(np.uint16)
        if np.array_equal(u16.astype(np.float32), hp):
            hp = u16
        mask = mask.astype(np.float32)
        m8 = mask.astype(np.uint8)
        if np.array_equal(m8.astype(np.float32), mask):
            mask = m8
        return hp, mask, tuple(vox), ds, proton
    except Exception:
        return None, None, None, None, None


def _pow2_at_least(n: int, floor: int = 256) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(n, 1)))))


# StudyMetrics fields in the column order of the metrics vector.  Every
# field is exactly float32-representable (floats are float32 already,
# counts < 2^24, bools 0/1), so the [B, n_fields] vector round-trips.
_METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(StudyMetrics))
_METRIC_INT_FIELDS = ("ci_saturated",)
_METRIC_BOOL_FIELDS = ("ci_overflow", "n4_overflow", "valid")


def _pack_metrics_vec(metrics: StudyMetrics) -> torch.Tensor:
    """On the device: StudyMetrics -> [B, n_fields] float32."""
    return torch.stack([getattr(metrics, f).to(torch.float32)
                        for f in _METRIC_FIELDS], dim=-1)


def _metrics_from_vec(v) -> StudyMetrics:
    """On the host: metrics vector -> StudyMetrics of numpy columns (batch
    or single)."""
    v = np.asarray(v)
    kw = {}
    for i, f in enumerate(_METRIC_FIELDS):
        col = v[..., i]
        if f in _METRIC_INT_FIELDS:
            col = col.astype(np.int32)
        elif f in _METRIC_BOOL_FIELDS:
            col = col.astype(bool)
        kw[f] = col
    return StudyMetrics(**kw)


def _lane(host: Dict, i: int) -> Dict:
    """One subject's slice of a host pack (metrics included)."""
    out = {k: v[i] for k, v in host.items() if k != "metrics"}
    m = host["metrics"]
    out["metrics"] = StudyMetrics(**{f: getattr(m, f)[i]
                                     for f in _METRIC_FIELDS})
    return out


class _GeometryRunner:
    """Per-(shape, vox) batcher: config/geometry cache and sticky pads.

    ``dispatch`` runs on the caller's (dispatch) thread; ``bump_for_retry``
    runs in the export workers, which read the overflow flags.  Both take
    ``_bucket_lock`` for every read and write of the sticky state, so a
    dispatch sees one consistent snapshot of it.
    """

    def __init__(self, shape, vox, config: VentConfig, batch_size: int,
                 adaptive_pad: bool = False, device="cuda",
                 mesh: Optional[dmesh.Mesh] = None):
        self.shape = tuple(shape)
        self.vox = tuple(vox)
        self.config = config
        self.bs = batch_size
        self.device = resolve_device(device)
        # A batch mesh (use_mesh): each batch is split over its shards
        # (dist.shard_cohort_fn), so bs is a multiple of the mesh size.
        self.mesh = mesh
        # adaptive_pad (the serving path): pad a partial batch to the next
        # power of two >= its size (at most bs, a multiple of the mesh
        # size) instead of to bs, so a single subject moves 1 lane, not bs
        # zero lanes.  Offline cohort runs keep the fixed pad.
        self.adaptive = adaptive_pad
        self.items: List[Tuple[Dict, Tuple]] = []
        # Sticky buckets: start small, grow on overflow, never shrink
        # within a run.
        self.ci_bucket = min(512, config.ci_max_defect_voxels)
        self.n4_bucket = min(8192, config.n4_mask_pad)
        # Set when a CI overflow persists at the pad ceiling (a tail-budget
        # overflow of the pairwise engine, not a defect-count overflow):
        # the CI tail then runs at full width (tail_k = the pad).
        self.ci_tail_full = False
        self._cfgs: Dict[Tuple[int, int, bool], Tuple] = {}
        self._bucket_lock = threading.Lock()

    def _fn(self, ci_pad: int, n4_pad: int, tail_full: bool = False):
        """(config, geometry) for one set of pads."""
        key = (ci_pad, n4_pad, tail_full)
        if key not in self._cfgs:
            cfg = self.config.replace(
                ci_max_defect_voxels=ci_pad, n4_mask_pad=n4_pad,
                ci_tail_k=ci_pad if tail_full else self.config.ci_tail_k)
            self._cfgs[key] = (cfg, build_geometry(self.vox, self.shape, cfg))
        return self._cfgs[key]

    def add(self, entry: Dict, decoded: Tuple) -> bool:
        self.items.append((entry, decoded))
        return len(self.items) >= self.bs

    def take_batch(self) -> List[Tuple[Dict, Tuple]]:
        batch, self.items = self.items[:self.bs], self.items[self.bs:]
        return batch

    @property
    def _n4_cap(self) -> int:
        return min(int(np.prod(self.shape)), self.config.n4_mask_pad)

    @property
    def _ci_cap(self) -> int:
        return self.config.ci_max_defect_voxels

    def _eff_bs(self, n: int) -> int:
        """Padded size for an n-subject batch (see adaptive_pad above)."""
        if not self.adaptive:
            return self.bs
        n_dev = self.mesh.size if self.mesh is not None else 1
        eff = min(max(_pow2_at_least(n, floor=1), n_dev), self.bs)
        return -(-eff // n_dev) * n_dev

    def dispatch(self, batch):
        """Analyse one padded batch at the current sticky buckets.

        Returns (device pack, pads) without reading any result back: the
        export worker reads the overflow flags when it copies the pack to
        the host, and an overflowed batch comes back through
        ``bump_for_retry`` and the retry queue.
        """
        n = len(batch)
        pad = self._eff_bs(n) - n
        hp_np = np.stack([np.asarray(d[0], np.float32) for _, d in batch]
                         + [np.zeros(self.shape, np.float32)] * pad)
        masks = [d[1] for _, d in batch]
        mdt = np.uint8 if all(m.dtype == np.uint8 for m in masks) \
            else np.float32
        mask_np = np.stack([m.astype(mdt, copy=False) for m in masks]
                           + [np.zeros(self.shape, mdt)] * pad)
        max_mask = int((mask_np > 0).sum(axis=(1, 2, 3)).max())
        with self._bucket_lock:
            self.n4_bucket = min(
                max(self.n4_bucket, _pow2_at_least(max_mask, 8192)),
                self._n4_cap)
            pads = (self.ci_bucket, self.n4_bucket, self.ci_tail_full)
        cfg, geom = self._fn(*pads)
        hp, mask = torch.from_numpy(hp_np), torch.from_numpy(mask_np)
        if self.mesh is None:
            res = analyze_cohort(hp.to(self.device), mask.to(self.device),
                                 geom, cfg)
        else:   # each shard moves its own lanes to its device
            res = dmesh.shard_cohort_fn(
                lambda h, m: analyze_cohort(h, m, geom, cfg), self.mesh)(
                    hp, mask)
        B = res.defect.shape[0]
        V = int(np.prod(self.shape))
        # The CI values at the engines' own ascending-flat defect
        # compaction: the host rebuilds the dense map bit-exactly from them
        # (_densify_ci), including an overflowed lane's first-K truncation.
        cidx, n_def = compact_mask_indices(
            res.defect.reshape(B, V) != 0, min(pads[0], V))
        pack = {
            "n4": res.n4,
            "defect": res.defect.to(torch.uint8),
            "ci_cv": res.ci_map.reshape(B, V).gather(1, cidx),
            "n_def": n_def,
            "mvec": _pack_metrics_vec(res.metrics),
        }
        return pack, pads

    @property
    def _engine_pairwise(self) -> bool:
        """Whether this geometry gets the pairwise CI engine: the tail
        escalation exists only there (the ladder has no tail budget)."""
        return isinstance(build_geometry(self.vox, self.shape, self.config),
                          CIPairwiseGeometry)

    def bump_for_retry(self, ci_ovf: bool, n4_ovf: bool, pads) -> bool:
        """Grow the sticky buckets after an overflow observed at ``pads``.

        Returns True when a retry at larger budgets is warranted; False when
        every escalation is spent (the flags then stand in the exported
        metrics, never silently).  Growth is idempotent per level, so export
        workers that observe the same overflow bump once, not once each.

        The CI flag covers two causes: more defect voxels than the pad, and
        (pairwise engine) more head-unresolved rows than the tail budget.
        Pad doubling fixes both in most cases (the default tail scales as
        K // 8); when the flag still stands at the pad ceiling, one last
        retry runs the tail at full width, after which a standing flag is a
        true defect-count overflow.
        """
        ci_pad, n4_pad, tail_full = pads
        with self._bucket_lock:
            retry = False
            if ci_ovf:
                if self.ci_bucket <= ci_pad:
                    if self.ci_bucket < self._ci_cap:
                        self.ci_bucket = min(ci_pad * 2, self._ci_cap)
                    elif not self.ci_tail_full and self._engine_pairwise:
                        self.ci_tail_full = True
                retry = (self.ci_bucket > ci_pad
                         or (self.ci_tail_full and not tail_full))
            if n4_ovf:
                if self.n4_bucket <= n4_pad:
                    self.n4_bucket = min(n4_pad * 2, self._n4_cap)
                retry = retry or self.n4_bucket > n4_pad
            return retry


def run_cohort(
    manifest: List[Dict],
    out_dir: str,
    config: VentConfig = DEFAULT_CONFIG,
    batch_size: Optional[int] = None,
    resume: bool = True,
    decode_workers: int = 8,
    export_workers: int = 4,
    progress: Optional[Callable[[str, int, int], None]] = None,
    runners: Optional[Dict[Tuple, "_GeometryRunner"]] = None,
    export_npz: bool = False,
    adaptive_pad: bool = False,
    device="cuda",
    use_mesh: bool = False,
) -> List[Dict]:
    """Analyse every subject of the manifest; returns per-subject metrics.

    Runs on ``device``: the current CUDA card by default, and the CPU only
    when asked (``device="cpu"``).  Without a card the default raises a
    RuntimeError before any subject is read.
    Decode prefetch is bounded at two batches ahead and exports run in
    background threads with at most two batches queued, so host memory
    stays O(batch_size x geometries) on any cohort size.
    ``progress(stage, done, total)`` is called as subjects decode
    ("decode"), as batches are analysed ("analyze") and as exports land
    per subject ("export"; also with an unchanged count when an overflowed
    batch re-queues, as a keep-alive).  Callbacks fire from the decode and
    export threads as well as the dispatch thread.

    ``runners`` lets a long-lived caller keep the per-geometry runners (and
    their sticky pads) across calls; config, batch_size, adaptive_pad and
    use_mesh must then stay fixed (the runners keep the device and mesh
    they were made on).  ``adaptive_pad`` pads a partial batch to the
    next power of two instead of to batch_size.

    ``use_mesh`` with more than one local device that ``device`` names
    (``dist.local_devices``: every visible card for ``"cuda"``, the one
    card of ``"cuda:1"``) splits each batch over a batch mesh of them
    (``dist.shard_cohort_fn``; batch_size, default max(devices, 8), rounded
    up to a multiple of the device count); with one device it changes
    nothing.  It is off by default, unlike ventjax's: the mesh runs its
    shards one after another on the host thread, and each shard of this
    launch- and sync-bound pipeline costs about a whole batch, so n cards
    would take about n times one card's time.
    """
    devices = dmesh.local_devices(device) if use_mesh else None
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    todo: List[Dict] = []
    results: List[Dict] = []
    for entry in manifest:
        sdir = os.path.join(out_dir, entry["id"])
        if resume and os.path.exists(os.path.join(sdir, ".done")):
            try:
                with open(os.path.join(sdir, "metrics.json")) as f:
                    results.append(json.load(f))
            except OSError:
                results.append({"id": entry["id"], "resumed": True})
            continue
        todo.append(entry)
    if not todo:
        return results

    devices = devices or [device]
    n_dev = len(devices)
    bs = batch_size or max(n_dev, 8)
    bs = -(-bs // n_dev) * n_dev   # divisible by the mesh size
    mesh = dmesh.make_batch_mesh(devices=devices) if n_dev > 1 else None
    if runners is None:
        runners = {}
    results_lock = threading.Lock()
    n_done = 0
    n_exported = 0
    total = len(todo)

    export_pool = ThreadPoolExecutor(max_workers=export_workers)
    export_futures = []
    # Backpressure: at most 2 batches of results may wait for export.
    export_slots = threading.BoundedSemaphore(2)
    # Overflowed batches come back here for re-dispatch at grown pads (the
    # dispatch thread drains it); the flags are read in the export workers.
    retry_lock = threading.Lock()
    retry_queue: deque = deque()

    def _touch_export(k=1):
        nonlocal n_exported
        with results_lock:
            n_exported += k
            cnt = n_exported
        if progress:
            progress("export", cnt, total)

    def _export_batch(runner, batch, pack, pads):
        try:
            # The first host sync of the batch: the copy to the host.
            host = {k: v.cpu().numpy() for k, v in pack.items()
                    if k != "mvec"}
            host["metrics"] = _metrics_from_vec(pack["mvec"].cpu().numpy())
            n = len(batch)
            # Overflow on a valid lane only: an empty-mask subject runs on
            # a stand-in all-ones mask whose defects always overflow the CI
            # pad; its flags still export (valid=False says why).
            m = host["metrics"]
            ci_ovf = bool((m.ci_overflow & m.valid)[:n].any())
            n4_ovf = bool((m.n4_overflow & m.valid)[:n].any())
            if (ci_ovf or n4_ovf) and runner.bump_for_retry(ci_ovf, n4_ovf,
                                                            pads):
                log.info("geometry %s: overflow at ci=%d n4=%d "
                         "tail_full=%s, queueing batch for re-run",
                         runner.shape, *pads)
                with retry_lock:
                    retry_queue.append((runner, batch))
                _touch_export(0)
                return
            for lane, (entry, decoded) in enumerate(batch):
                _write_subject(out_dir, entry, decoded, _lane(host, lane),
                               results, results_lock, npz=export_npz,
                               config=config)
                _touch_export()
        finally:
            export_slots.release()

    def submit_export(runner, batch, pack, pads, is_retry=False):
        nonlocal n_done
        export_slots.acquire()
        export_futures.append(
            export_pool.submit(_export_batch, runner, batch, pack, pads))
        if not is_retry:
            n_done += len(batch)
            if progress:
                progress("analyze", n_done, total)
            log.info("analyzed %d/%d subjects", n_done, total)

    def drain_retries():
        """Re-dispatch overflowed batches at their grown pads (dispatch
        thread only); a retry that overflows again re-queues until the
        ceilings stop bump_for_retry."""
        while True:
            with retry_lock:
                if not retry_queue:
                    return
                runner, batch = retry_queue.popleft()
            pack, pads = runner.dispatch(batch)
            submit_export(runner, batch, pack, pads, is_retry=True)

    def handle(entry, decoded):
        nonlocal n_done
        if decoded[0] is None:
            metrics = {"id": entry["id"], "valid": False,
                       "error": "decode_failed"}
            sdir = os.path.join(out_dir, entry["id"])
            os.makedirs(sdir, exist_ok=True)
            with open(os.path.join(sdir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
            with results_lock:
                results.append(metrics)
            n_done += 1
            return
        geo = (decoded[0].shape, decoded[2])
        if geo not in runners:
            runners[geo] = _GeometryRunner(geo[0], geo[1], config, bs,
                                           adaptive_pad=adaptive_pad,
                                           device=device, mesh=mesh)
        runner = runners[geo]
        if runner.add(entry, decoded):
            batch = runner.take_batch()
            pack, pads = runner.dispatch(batch)
            submit_export(runner, batch, pack, pads)
        drain_retries()

    try:
        # Streaming decode: a bounded window of decode futures (2 batches
        # ahead) overlapping the device work and the exports.
        prefetch = max(2 * bs, decode_workers)
        with ThreadPoolExecutor(max_workers=decode_workers) as dpool:
            pending = deque()
            it = iter(todo)
            for entry in todo[:prefetch]:
                next(it)
                pending.append((entry, dpool.submit(_decode_subject, entry)))
            n_decoded = 0
            while pending:
                entry, fut = pending.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append((nxt, dpool.submit(_decode_subject, nxt)))
                decoded = fut.result()
                n_decoded += 1
                if progress:
                    progress("decode", n_decoded, total)
                handle(entry, decoded)

        # Flush the partial batch of every geometry.
        for runner in runners.values():
            while runner.items:
                batch = runner.take_batch()
                pack, pads = runner.dispatch(batch)
                submit_export(runner, batch, pack, pads)

        # Settle: exports may queue retries, whose exports may queue more;
        # alternate waiting and draining until both are empty.
        while True:
            pending_exports, export_futures = export_futures, []
            for f in pending_exports:
                f.result()  # surface export exceptions
            drain_retries()
            if not export_futures:
                break
    finally:
        export_pool.shutdown(wait=True)
    return results


def _densify_ci(pack: Dict) -> np.ndarray:
    """Rebuild the dense CI map from the compacted transfer.

    The engines write CI values only at defect voxels, in ascending flat
    (C-order) position, the order ``ci_cv`` was gathered in; scattering the
    first n_def values back over the defect indices reproduces the device's
    map bit for bit, including the first-K truncation of an overflowed lane
    (flagged by metrics.ci_overflow)."""
    cv = np.asarray(pack["ci_cv"])
    n = min(int(pack["n_def"]), cv.shape[0])
    defect = np.asarray(pack["defect"])
    idx = np.flatnonzero(defect.reshape(-1))[:n]
    ci = np.zeros(defect.size, np.float32)
    ci[idx] = cv[:len(idx)]
    return ci.reshape(defect.shape)


def _write_subject(out_dir, entry, decoded, pack, results, lock, npz=False,
                   config=None) -> None:
    """Write one subject's exports; ``pack`` is its host-side slice (n4
    float32, defect uint8, ci_cv/n_def, metrics).  The ``.done`` marker is
    written last, so a marker implies a complete export."""
    hp, mask, vox, ds, proton = decoded
    # exports keep the float32 convention of the reference's artifacts
    hp = np.asarray(hp, np.float32)
    mask = np.asarray(mask, np.float32)
    ci_map = _densify_ci(pack)
    sid = entry["id"]
    sdir = os.path.join(out_dir, sid)
    os.makedirs(sdir, exist_ok=True)
    metrics = {"id": sid, **pack["metrics"].as_dict()}
    rexport.export_nifti(
        sdir, sid, hp, mask, proton=proton, n4=np.asarray(pack["n4"]),
        defect=np.asarray(pack["defect"], dtype=np.float32), ci=ci_map)
    with open(os.path.join(sdir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    if ds is not None:
        rexport.dicom_to_json(ds, os.path.join(sdir, f"{sid}.json"))
    if npz:
        # the versioned NPZ study artifact, written before the .done marker
        # so resume never trusts a torn artifact
        state = {
            "HPvent": hp, "mask": mask,
            "N4HPvent": np.asarray(pack["n4"]),
            "defectArray": np.asarray(pack["defect"], np.float64),
            "CIarray": ci_map,
            "vox": [float(v) for v in vox],
            "metadata": metrics,
        }
        if proton is not None:
            state["proton"] = proton
        if config is not None:
            state["config"] = config
        rexport.save_npz(state, os.path.join(sdir, f"{sid}.npz"))
    with open(os.path.join(sdir, ".done"), "w") as f:
        f.write("ok\n")
    with lock:
        results.append(metrics)
