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

The device-to-host pack is compact by default (``compact_export``, as
ventjax's): N4's corrected values at the mask's compaction and the flat
B-spline lattices, the defect map as the CI compaction's indices, and the
CI values there with their count; the host rebuilds the dense channels
(``_rebuild_compact_pack``, ``_densify_ci``).  The dense pack (the N4 image
in float32, the defect map in uint8) is taken where the compact one cannot
hold the batch: a mask larger than the N4 pad, or a CI overflow that
outlives every budget (``ci_force_dense``).  ventjax ships the compact pack
as one blob, which pays its TPU link's per-transfer latency once; here its
leaves move as they are.

Several processes: where ``torch.distributed`` is initialised with more
than one rank (``dist.initialize_multihost``; the counterpart of
``jax.process_count() > 1``), every rank runs the same dispatch sequence
over the same manifest.  Rank 0's view of the ``.done`` markers is
broadcast first.  With ``use_mesh`` each batch is split over a
``RankMesh``: every rank decodes the whole batch and analyses only its own
lanes on its device.  The export packs are gathered on the dispatch
thread, and rank 0 writes every file (process-0 export); with
``shard_export`` only the metrics vectors are gathered and each rank
writes its own lanes.  Every collective is issued from the dispatch
thread, in the same order on every rank; the export workers do file I/O
only.

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


def _lane_metrics(m: StudyMetrics, i: int) -> StudyMetrics:
    return StudyMetrics(**{f: getattr(m, f)[i] for f in _METRIC_FIELDS})


def _lane(host: Dict, i: int) -> Dict:
    """One subject's slice of a host pack (metrics included)."""
    out = {k: v[i] for k, v in host.items() if k != "metrics"}
    out["metrics"] = _lane_metrics(host["metrics"], i)
    return out


def _process_count() -> int:
    """Ranks of the default torch.distributed group (1 where there is
    none)."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


class _GeometryRunner:
    """Per-(shape, vox) batcher: config/geometry cache and sticky pads.

    ``dispatch`` runs on the caller's (dispatch) thread; ``bump_for_retry``
    runs in the export workers, which read the overflow flags.  Both take
    ``_bucket_lock`` for every read and write of the sticky state, so a
    dispatch sees one consistent snapshot of it.
    """

    def __init__(self, shape, vox, config: VentConfig, batch_size: int,
                 adaptive_pad: bool = False, device="cuda",
                 mesh=None, compact_export: bool = True):
        self.shape = tuple(shape)
        self.vox = tuple(vox)
        self.config = config
        self.bs = batch_size
        self.device = resolve_device(device)
        # A batch mesh (use_mesh): each batch is split over its shards
        # (dist.shard_cohort_fn), so bs is a multiple of the mesh size.  On
        # a RankMesh (several processes) this rank analyses its own lanes
        # only, and dispatch returns their pack.
        self.mesh = mesh
        # adaptive_pad (the serving path): pad a partial batch to the next
        # power of two >= its size (at most bs, a multiple of the mesh
        # size) instead of to bs, so a single subject moves 1 lane, not bs
        # zero lanes.  Offline cohort runs keep the fixed pad.
        self.adaptive = adaptive_pad
        # The compact device-to-host pack (see the module docstring); a
        # batch whose largest mask exceeds the N4 pad takes the dense one,
        # since the rebuild needs every masked voxel shipped.
        self.compact = compact_export
        self.items: List[Tuple[Dict, Tuple]] = []
        # Sticky buckets: start small, grow on overflow, never shrink
        # within a run.
        self.ci_bucket = min(512, config.ci_max_defect_voxels)
        self.n4_bucket = min(8192, config.n4_mask_pad)
        # Set when a CI overflow persists at the pad ceiling (a tail-budget
        # overflow of the pairwise engine, not a defect-count overflow):
        # the CI tail then runs at full width (tail_k = the pad).
        self.ci_tail_full = False
        # Set when a CI overflow outlives every budget: the compact pack
        # would export a truncated defect channel (only the first K
        # indices travel), so such batches re-run with the dense pack,
        # whose uint8 defect map is always complete.
        self.ci_force_dense = False
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
        ``bump_for_retry`` and the retry queue.  On a RankMesh the pack
        holds this rank's lanes only.
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
            compact = (self.compact and pads[1] >= max_mask
                       and not self.ci_force_dense)
        cfg, geom = self._fn(*pads)
        if isinstance(self.mesh, dmesh.Mesh):
            # each shard moves its own lanes to its device
            res = dmesh.shard_cohort_fn(
                lambda h, m: analyze_cohort(h, m, geom, cfg,
                                            export_compact=compact),
                self.mesh)(torch.from_numpy(hp_np),
                           torch.from_numpy(mask_np))
        else:
            if self.mesh is not None:
                # a RankMesh: every rank stacked the whole batch (the pads
                # above agree); it feeds only its own lanes
                own = self.mesh.lanes(hp_np.shape[0])
                hp_np, mask_np = hp_np[own], mask_np[own]
            res = analyze_cohort(torch.from_numpy(hp_np).to(self.device),
                                 torch.from_numpy(mask_np).to(self.device),
                                 geom, cfg, export_compact=compact)
        B = res.defect.shape[0]
        V = int(np.prod(self.shape))
        # The CI values at the engines' own ascending-flat defect
        # compaction: the host rebuilds the dense map bit-exactly from them
        # (_densify_ci), including an overflowed lane's first-K truncation.
        # The compact pack carries those indices as its defect map.
        cidx, n_def = compact_mask_indices(
            res.defect.reshape(B, V) != 0, min(pads[0], V))
        pack = {
            "ci_cv": res.ci_map.reshape(B, V).gather(1, cidx),
            "n_def": n_def,
            "mvec": _pack_metrics_vec(res.metrics),
        }
        if compact:
            pack.update(n4_cv=res.export["n4_cv"], phi=res.export["phi"],
                        cidx=cidx)
        else:
            pack.update(n4=res.n4, defect=res.defect.to(torch.uint8))
        return pack, pads

    @property
    def _engine_pairwise(self) -> bool:
        """Whether this geometry gets the pairwise CI engine: the tail
        escalation exists only there (the ladder has no tail budget)."""
        return isinstance(build_geometry(self.vox, self.shape, self.config),
                          CIPairwiseGeometry)

    def bump_for_retry(self, ci_ovf: bool, n4_ovf: bool, pads,
                       compact_pack: bool = False) -> bool:
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
        true defect-count overflow; a batch that came in the compact pack
        (``compact_pack``) then re-runs once more with the dense pack
        (``ci_force_dense``), so that its defect channel is complete.
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
                    elif compact_pack and not self.ci_force_dense:
                        self.ci_force_dense = True
                retry = (self.ci_bucket > ci_pad
                         or (self.ci_tail_full and not tail_full)
                         or (self.ci_force_dense and compact_pack))
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
    shard_export: bool = False,
    compact_export: bool = True,
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

    Several processes (a torch.distributed default group of more than one
    rank): every rank calls run_cohort with the same arguments.  Rank 0's
    done markers are broadcast, so every rank skips the same subjects (a
    done subject whose ``metrics.json`` a rank cannot read comes back as
    ``{"id": ..., "resumed": True}`` there).  ``use_mesh`` then splits each
    batch over a ``RankMesh``, one shard per rank on the rank's device
    (batch_size rounded up to a multiple of the world size); without it
    every rank analyses every lane.  Rank 0 writes every file after an
    all-gather of the export pack, and the other ranks record the metrics.
    ``shard_export`` (only where the batch really is split over the ranks;
    otherwise process-0 export) gathers only the per-lane metrics vector:
    every rank records every lane's metrics and writes the files of the
    lanes it owns, stamping ``export_process`` (its rank) into
    ``metrics.json``; the ranks then need one shared filesystem.  The
    overflow and retry decision is taken from the gathered metrics of the
    valid lanes, identically on every rank, and a retried batch re-runs on
    every rank.  No rank returns before every rank's exports are written.

    ``compact_export`` (default True, as ventjax's): the device-to-host pack
    carries N4's masked values and the B-spline lattices, and the defect
    map as the CI compaction's indices; the host rebuilds the dense
    channels.  The masked N4 voxels, the defect and CI channels and the
    metrics are the dense pack's bits; the out-of-mask N4 background
    (analysed by nothing) comes from the host's float64 lattice
    evaluation, within ~1e-6 relative of the card's.  False ships the
    dense volumes.
    """
    multiproc = _process_count() > 1
    rank_mesh = dmesh.make_rank_mesh(device) if multiproc else None
    devices = dmesh.local_devices(device) if use_mesh and not multiproc \
        else None
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    done_flags = np.array(
        [1 if resume and os.path.exists(os.path.join(out_dir, e["id"],
                                                     ".done")) else 0
         for e in manifest], np.int32)
    if multiproc:
        # Rank 0 owns the done markers: its view goes to every rank, so
        # every rank runs the same dispatch sequence (divergent todo lists
        # would leave the collectives unmatched).
        done_flags = dmesh.broadcast_one_to_all(done_flags, rank_mesh)
    todo: List[Dict] = []
    results: List[Dict] = []
    for entry, done in zip(manifest, done_flags):
        if done:
            try:
                with open(os.path.join(out_dir, entry["id"],
                                       "metrics.json")) as f:
                    results.append(json.load(f))
            except OSError:
                # a rank that does not share rank 0's filesystem
                results.append({"id": entry["id"], "resumed": True})
            continue
        todo.append(entry)
    if not todo:
        return results

    if multiproc:
        mesh = rank_mesh if use_mesh else None
        n_dev = rank_mesh.size if use_mesh else 1
    else:
        devices = devices or [device]
        n_dev = len(devices)
        mesh = dmesh.make_batch_mesh(devices=devices) if n_dev > 1 else None
    bs = batch_size or max(n_dev, 8)
    bs = -(-bs // n_dev) * n_dev   # divisible by the mesh size
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
    # dispatch thread drains it); one process reads the flags in the export
    # workers, several on the dispatch thread.
    retry_lock = threading.Lock()
    retry_queue: deque = deque()

    def _touch_export(k=1):
        nonlocal n_exported
        with results_lock:
            n_exported += k
            cnt = n_exported
        if progress:
            progress("export", cnt, total)

    def _requeued(runner, batch, m, pads, compact_pack) -> bool:
        """Queue the batch for a re-run when a valid lane overflowed and
        the pads can still grow.  An empty-mask subject runs on a stand-in
        all-ones mask whose defects always overflow the CI pad; its flags
        still export (valid=False says why)."""
        n = len(batch)
        ci_ovf = bool((m.ci_overflow & m.valid)[:n].any())
        n4_ovf = bool((m.n4_overflow & m.valid)[:n].any())
        if (ci_ovf or n4_ovf) and runner.bump_for_retry(
                ci_ovf, n4_ovf, pads, compact_pack=compact_pack):
            log.info("geometry %s: overflow at ci=%d n4=%d tail_full=%s, "
                     "queueing batch for re-run", runner.shape, *pads)
            with retry_lock:
                retry_queue.append((runner, batch))
            _touch_export(0)
            return True
        return False

    def _submit(fn, *args, **kw):
        """fn in an export worker, holding one of the export slots."""
        export_slots.acquire()

        def run():
            try:
                fn(*args, **kw)
            finally:
                export_slots.release()
        export_futures.append(export_pool.submit(run))

    def _write_lanes(lanes, **kw):
        """File I/O only: (entry, decoded, host lane pack) triples."""
        for entry, decoded, lane_pack in lanes:
            _write_subject(out_dir, entry, decoded, lane_pack, results,
                           results_lock, npz=export_npz, config=config, **kw)
            _touch_export()

    def _export_batch(runner, batch, pack, pads):
        """One process: the copy to the host (the batch's first host
        sync), the overflow check and the files, in an export worker."""
        host = {k: v.cpu().numpy() for k, v in pack.items() if k != "mvec"}
        host["metrics"] = _metrics_from_vec(pack["mvec"].cpu().numpy())
        if not _requeued(runner, batch, host["metrics"], pads,
                         "n4_cv" in pack):
            _write_lanes([(e, d, _lane(host, i))
                          for i, (e, d) in enumerate(batch)])

    def _record(batch, m):
        with results_lock:
            for lane, (entry, _) in enumerate(batch):
                results.append({"id": entry["id"],
                                **_lane_metrics(m, lane).as_dict()})

    def _gather_batch(runner, batch, pack, pads):
        """Several processes, on the dispatch thread: every collective of
        the batch, in the same order on every rank."""
        sharded = isinstance(runner.mesh, dmesh.RankMesh)
        if sharded and shard_export:
            m = _metrics_from_vec(
                dmesh.process_allgather(pack["mvec"], runner.mesh).numpy())
            if _requeued(runner, batch, m, pads, "n4_cv" in pack):
                return
            _record(batch, m)   # every rank records every lane
            own = runner.mesh.lanes(runner.mesh.size * pack["mvec"].shape[0])
            local = {k: v.cpu().numpy() for k, v in pack.items()
                     if k != "mvec"}
            owned = [(*batch[lane], {**{k: v[i] for k, v in local.items()},
                                     "metrics": _lane_metrics(m, lane)})
                     for i, lane in enumerate(range(own.start, own.stop))
                     if lane < len(batch)]
            if owned:
                _submit(_write_lanes, owned, record=False,
                        exporter=rank_mesh.index)
            return
        host = {k: (dmesh.process_allgather(v, runner.mesh) if sharded
                    else v.cpu()).numpy() for k, v in pack.items()}
        host["metrics"] = _metrics_from_vec(host.pop("mvec"))
        if _requeued(runner, batch, host["metrics"], pads, "n4_cv" in pack):
            return
        if rank_mesh.index == 0:
            _submit(_write_lanes, [(e, d, _lane(host, i))
                                   for i, (e, d) in enumerate(batch)])
        else:
            # recording the metrics is this rank's export: it feeds the
            # watchdog as rank 0's files do
            _record(batch, host["metrics"])
            _touch_export(len(batch))

    def submit_export(runner, batch, pack, pads, is_retry=False):
        nonlocal n_done
        if multiproc:
            _gather_batch(runner, batch, pack, pads)
        else:
            _submit(_export_batch, runner, batch, pack, pads)
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
                                           device=device, mesh=mesh,
                                           compact_export=compact_export)
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
        if multiproc:
            # No rank returns before every rank's files are durable: a
            # caller that resumes at once must see all the done markers.
            import torch.distributed as tdist

            tdist.barrier(group=rank_mesh.group)
    finally:
        export_pool.shutdown(wait=True)
    return results


def _densify_ci(pack: Dict, shape=None) -> np.ndarray:
    """Rebuild the dense CI map from the compacted transfer.

    The engines write CI values only at defect voxels, in ascending flat
    (C-order) position, the order ``ci_cv`` was gathered in; scattering the
    first n_def values back over the defect indices reproduces the device's
    map bit for bit, including the first-K truncation of an overflowed lane
    (flagged by metrics.ci_overflow).  A dense pack carries the defect map
    (the host takes its flatnonzero); a compact one the device's own
    compaction indices (``cidx``), with ``shape`` for the volume."""
    cv = np.asarray(pack["ci_cv"])
    n = min(int(pack["n_def"]), cv.shape[0])
    if "defect" in pack:
        defect = np.asarray(pack["defect"])
        shape = defect.shape
        idx = np.flatnonzero(defect.reshape(-1))[:n]
    else:
        idx = np.asarray(pack["cidx"][:n], np.int64)
    ci = np.zeros(int(np.prod(shape)), np.float32)
    ci[idx] = cv[:len(idx)]
    return ci.reshape(shape)


def _rebuild_compact_pack(pack: Dict, hp: np.ndarray, mask: np.ndarray,
                          config: VentConfig) -> Dict:
    """The dense N4 (float32) and defect (uint8) channels of ONE subject
    from its compact pack.

    - defect: 1 at the device's own ``cidx[:n_def]`` compaction indices,
      bit-exact (truncated only where n_def exceeded the pad, which
      metrics.ci_overflow flags);
    - n4: ``hp * exp(-field)`` with the field from the shipped lattices
      (float64, ``ops.n4.n4_field_from_phi_np``), then every masked voxel
      overwritten with its shipped device value.  The masked voxels, the
      only ones a metric reads, are the dense pack's bits; the background
      agrees with the card to ~1e-6 relative.
    A subject with an empty mask (invalid) has no masked voxel to
    overwrite: its N4 channel is the host's alone, and its defect channel
    the device's (flagged) first K of the stand-in mask's."""
    from ventjax_torch.ops.n4 import n4_field_from_phi_np

    shape = hp.shape
    n4_cv = np.asarray(pack["n4_cv"])
    midx = np.flatnonzero(np.asarray(mask).reshape(-1) > 0)[:n4_cv.shape[0]]
    field = n4_field_from_phi_np(
        np.asarray(pack["phi"]), shape,
        fitting_levels=config.n4_fitting_levels,
        control_points=config.n4_control_points)
    # flat in C order whatever the operands' memory layout (a decoded
    # volume is often a transposed view): reshape(-1) of a non-C-contiguous
    # product is a copy, into which the overwrite would be lost
    n4 = (np.asarray(hp, np.float64) * np.exp(-field)).astype(
        np.float32).reshape(-1)
    n4[midx] = n4_cv[:len(midx)]
    defect = np.zeros(int(np.prod(shape)), np.uint8)
    n = min(int(pack["n_def"]), np.asarray(pack["cidx"]).shape[0])
    defect[np.asarray(pack["cidx"][:n], np.int64)] = 1
    out = dict(pack)
    out["n4"] = n4.reshape(shape)
    out["defect"] = defect.reshape(shape)
    return out


def _write_subject(out_dir, entry, decoded, pack, results, lock, npz=False,
                   config=None, record=True, exporter=None) -> None:
    """Write one subject's exports; ``pack`` is its host-side slice: the
    dense flavour (n4 float32, defect uint8) or the compact one
    (n4_cv/phi/cidx, ``_rebuild_compact_pack``), with ci_cv/n_def and the
    metrics.  The ``.done`` marker is
    written last, so a marker implies a complete export.  ``record=False``
    skips the results entry (shard_export records on the dispatch thread);
    ``exporter`` stamps the rank that wrote the files into metrics.json
    as ``export_process``."""
    hp, mask, vox, ds, proton = decoded
    # exports keep the float32 convention of the reference's artifacts
    hp = np.asarray(hp, np.float32)
    mask = np.asarray(mask, np.float32)
    if "n4_cv" in pack:
        pack = _rebuild_compact_pack(pack, hp, mask,
                                     config or DEFAULT_CONFIG)
    ci_map = _densify_ci(pack)
    sid = entry["id"]
    sdir = os.path.join(out_dir, sid)
    os.makedirs(sdir, exist_ok=True)
    metrics = {"id": sid, **pack["metrics"].as_dict()}
    if exporter is not None:
        metrics["export_process"] = int(exporter)
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
    if record:
        with lock:
            results.append(metrics)
