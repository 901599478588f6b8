"""Watch-folder serving daemon — the production deployment surface.

The port's counterpart of ``ventjax/pipeline/serve.py``, on one CUDA card
unless the caller asks for the CPU (``device="cpu"``).  The reference is an
attended desktop app: an analyst loads one subject at a time and clicks
through the GUI (Vent_Analysis.py:856-864, one mutable Vent1 instance).  In
a production deployment the equivalent surface is an unattended service:
studies land in an inbox directory (scanner push, PACS export, rsync drop)
and results appear in an outbox.  ``python -m ventjax_torch serve``
provides that on top of the cohort driver (pipeline/cohort.py):

- **discovery by convention**: every immediate subdirectory of the inbox
  holding ``xenon.dcm`` + ``mask/`` (optional ``proton.dcm`` — the layout
  io/synthetic.py:write_study produces) is a subject; the directory name is
  the subject id and names its output directory;
- **arrival gating**: a subject is only picked up once its files stop
  changing (``min_age`` seconds since the newest mtime) or, with
  ``ready_marker``, once that sentinel file appears in the subject dir — so
  a study still being copied in is never half-decoded.  Producers that
  preserve source mtimes (``rsync -a``, ``scp -p``) defeat a pure mtime
  age test; for them set ``settle_scans=N`` to require the subject's file
  signature (names/sizes/mtimes) to be unchanged across N consecutive
  scans before first pickup, or use ``ready_marker`` (the explicit
  protocol).  Independent of ``settle_scans``, a signature that *changed*
  since the previous scan always holds the subject back one interval —
  this is what lets an operator fix a failed study in place without the
  half-written state being picked up;
- **warm serving**: the per-geometry runners (configs, CI geometries and
  sticky adaptive pads) persist across scans, so after the first study of
  a geometry every later one skips the geometry build and the pad growth
  and goes straight to the device; the CUDA kernels are built once per
  install (``prewarm`` builds them before the inbox opens);
- **exactly-once**: the cohort driver's ``.done`` markers carry over —
  restarting the service never re-analyzes or rewrites a completed subject,
  and a scan is O(new subjects), not O(inbox);
- **failure isolation + bounded retries**: a corrupt study poisons only its
  own lane (valid=False in its metrics.json), exactly as in batch cohort
  runs; a failed subject is re-attempted up to ``max_retries`` times with
  exponential backoff (transient I/O blips self-heal), and fixing the study
  *in place* (any file in its directory getting a newer mtime) re-arms it
  immediately with a fresh retry budget — no service restart needed.

The watcher is a single-process frontend; with ``use_mesh`` (off by
default, as in the cohort driver) a machine with several cards splits each
batch over a batch mesh of them.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ventjax_torch.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.pipeline.cohort import run_cohort
from ventjax_torch.utils.device import resolve_device

log = logging.getLogger("ventjax_torch.serve")

# Watchdog exit seam: the scan watchdog must end a process whose device
# thread is stuck in an uninterruptible runtime call (a wedged device
# blocks in native code with no Python frames to unwind — sys.exit from
# another thread would be swallowed), so it hard-exits via os._exit.
# Module-level so tests can observe the firing instead of dying.  The
# exit code is shared with the offline cohort watchdog so supervisors
# classify both the same way.
from ventjax_torch.utils.watchdog import EXIT_CODE as WATCHDOG_EXIT_CODE  # noqa: E402,E501

_watchdog_exit = os._exit


def _dir_state(d: str) -> Tuple[float, Tuple]:
    """(newest file mtime, signature) for ``d``.

    The signature — sorted (relpath, size, mtime) per file — detects a
    subject still changing between scans even when the producer preserves
    source mtimes.  Races with a producer mid-copy are benign: a vanished
    file is skipped and the next scan sees the final state.
    """
    newest = 0.0
    sig = []
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            try:
                st = os.stat(p)
            except OSError:
                continue
            newest = max(newest, st.st_mtime)
            sig.append((os.path.relpath(p, d), st.st_size, st.st_mtime))
    sig.sort()
    return newest, tuple(sig)


def _newest_mtime(d: str) -> float:
    """Newest file mtime under ``d`` (0.0 if empty)."""
    return _dir_state(d)[0]


def discover_subjects(
    inbox: str,
    ready_marker: Optional[str] = None,
    min_age: float = 0.0,
    _now: Optional[float] = None,
) -> Tuple[List[Dict], int]:
    """Scan the inbox for complete, settled subject directories.

    Returns (manifest_entries, n_pending) where pending counts directories
    that are visible but not yet eligible (incomplete layout, missing ready
    marker, or files newer than min_age) — they are expected to become
    eligible on a later scan and are never an error.
    """
    subjects: List[Dict] = []
    pending = 0
    try:
        names = sorted(os.listdir(inbox))
    except FileNotFoundError:
        raise FileNotFoundError(f"serve inbox does not exist: {inbox!r}")
    for name in names:
        d = os.path.join(inbox, name)
        if not os.path.isdir(d):
            continue
        xenon = os.path.join(d, "xenon.dcm")
        mask = os.path.join(d, "mask")
        if not (os.path.isfile(xenon) and os.path.isdir(mask)):
            pending += 1
            continue
        if ready_marker:
            if not os.path.exists(os.path.join(d, ready_marker)):
                pending += 1
                continue
        elif min_age > 0:
            now = time.time() if _now is None else _now
            if now - _newest_mtime(d) < min_age:
                pending += 1
                continue
        entry = {"id": name, "xenon": xenon, "mask": mask}
        proton = os.path.join(d, "proton.dcm")
        if os.path.isfile(proton):
            entry["proton"] = proton
        subjects.append(entry)
    return subjects, pending


@dataclasses.dataclass
class ScanReport:
    """One scan's outcome (serialized as the service's per-scan JSON line)."""

    scanned: int     # eligible subjects visible in the inbox
    new: int         # first seen by this scan
    analyzed: int    # of dispatched: exported with valid metrics
    failed: int      # of dispatched: decode/analysis failures (lane-isolated)
    resumed: int     # of new: already had .done markers (service restart)
    pending: int     # visible but not yet eligible (mid-copy / not ready)
    retried: int = 0  # previously-failed subjects re-attempted this scan

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _FailureState:
    """Retry bookkeeping for one failed subject (in-process only; across
    restarts the .done-marker protocol already retries failures)."""

    attempts: int = 0        # consecutive failed attempts since last re-arm
    next_retry: float = 0.0  # earliest wall time for the next attempt
    mtime: float = 0.0       # subject-dir newest mtime at the last attempt


class WatchService:
    """Long-lived serving loop over an inbox directory.

    Holds the persistent per-geometry runner dict so geometries and
    sticky pads survive across scans (the whole point of a daemon vs
    repeated ``cohort`` invocations).  Runs on ``device``: the current
    CUDA card by default, the CPU only when asked; without a card the
    default raises here, before any scan.  ``use_mesh`` is passed to every
    ``run_cohort`` call, with ``device`` as given (``"cuda"``: a batch mesh
    of every card where there are several).
    """

    def __init__(
        self,
        inbox: str,
        out_dir: str,
        config: VentConfig = DEFAULT_CONFIG,
        batch_size: Optional[int] = None,
        ready_marker: Optional[str] = None,
        min_age: float = 1.0,
        max_retries: int = 2,
        retry_backoff: float = 60.0,
        settle_scans: int = 0,
        export_npz: bool = False,
        device="cuda",
        use_mesh: bool = False,
    ):
        self.device = resolve_device(device)
        self.use_mesh = use_mesh
        self._cohort_device = device   # the mesh's devices, as named
        self.inbox = inbox
        self.out_dir = out_dir
        self.config = config
        self.batch_size = batch_size
        self.ready_marker = ready_marker
        self.min_age = min_age
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.settle_scans = settle_scans
        self.export_npz = export_npz
        # Persistent geometries + sticky pad buckets (cohort._GeometryRunner);
        # shared across every run_cohort call this service makes.
        self.runners: Dict[Tuple, object] = {}
        # Ids this process has successfully handled (analyzed or resumed) so
        # scans stay O(new).  On restart it is rebuilt lazily: the first scan
        # passes everything through run_cohort, whose .done markers make
        # resumed subjects a metrics.json read, not a re-analysis.
        self._served: set = set()
        # Failed subjects awaiting retry (bounded, backed-off, mtime-armed).
        self._failed: Dict[str, _FailureState] = {}
        # Last-seen file signature per unserved subject: a change between
        # scans means the producer is still writing (even with preserved
        # mtimes), so the subject is held back one more interval.
        self._sigs: Dict[str, Tuple] = {}
        # Consecutive scans each unserved subject's signature has been
        # stable (settle_scans gating for preserved-mtime producers).
        self._stable: Dict[str, int] = {}
        # Cumulative service counters (serve_status.json heartbeat).
        self._totals = {"scans": 0, "analyzed": 0, "failed": 0,
                        "resumed": 0, "scan_errors": 0}
        self._last_error: Optional[Dict] = None
        self._started = time.time()
        # Compact result of the last preflight() (None = never run);
        # included in every status heartbeat so monitors can see whether
        # the service started on a healthy install.
        self._preflight: Optional[Dict] = None
        # The watchdog timer thread writes the heartbeat while the scan
        # thread is (by premise) wedged, but serialize anyway so the
        # atomic tmp-file rename can never race itself.
        self._status_lock = threading.Lock()
        os.makedirs(out_dir, exist_ok=True)

    def preflight(self) -> Dict:
        """Run the doctor check battery (ventjax_torch.utils.doctor) on
        this service's device and record a compact result for the status
        heartbeat.  Returns the full report; callers decide whether a
        failed report blocks serving (the CLI's --preflight exits 2
        without scanning)."""
        from ventjax_torch.utils.doctor import run_doctor

        report = run_doctor(device=self.device)
        self._preflight = {
            "ts": time.time(),
            "ok": report["ok"],
            "failed": [c["name"] for c in report["checks"]
                       if c["required"] and not c["ok"]],
        }
        self._write_status(None)
        return report

    def prewarm(self, geometries, progress=None) -> float:
        """Warm the pipeline for expected study geometries BEFORE the
        inbox opens, so the first real arrival skips the kernel build and
        the geometry build (paid here instead).

        ``geometries``: iterable of ((H, W, D), (vox_r, vox_c, vox_s)).
        Each is driven through run_cohort on a synthetic phantom study in
        a temp dir with this service's persistent runner dict — exactly
        the production path (same batch padding, same runner), not a
        lookalike.  The sticky pad buckets start at the phantom's mask
        size; a real study with a larger mask still grows them once
        (inherent to adaptive padding).  Returns seconds spent.
        ``progress`` is forwarded to run_cohort (one decode/analyze/export
        event per geometry — lets a startup watchdog distinguish N slow
        steps from one wedge).
        """
        import shutil
        import tempfile

        from ventjax_torch.io.synthetic import write_study

        geometries = list(geometries)
        t0 = time.time()
        tmp = tempfile.mkdtemp(prefix="ventjax_torch_prewarm_")
        try:
            manifest = []
            for i, (shape, vox) in enumerate(geometries):
                root = os.path.join(tmp, f"warm{i}")
                write_study(root, shape=tuple(shape), vox=tuple(vox),
                            seed=i, with_proton=False)
                manifest.append({"id": f"warm{i}",
                                 "xenon": os.path.join(root, "xenon.dcm"),
                                 "mask": os.path.join(root, "mask")})
            if manifest:
                # adaptive_pad: serving dispatches pad to the smallest
                # power-of-two cover of the arrival burst, so this warms
                # the size-1 batch per geometry — the single-study
                # latency path.
                run_cohort(manifest, os.path.join(tmp, "out"),
                           config=self.config, batch_size=self.batch_size,
                           resume=False, runners=self.runners,
                           progress=progress, adaptive_pad=True,
                           device=self._cohort_device,
                           use_mesh=self.use_mesh)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        dt = time.time() - t0
        log.info("prewarmed %d geometr%s in %.1fs", len(geometries),
                 "y" if len(geometries) == 1 else "ies", dt)
        return dt

    def scan_once(self) -> ScanReport:
        """One discovery + analysis pass.  Blocks until exports complete."""
        subjects, pending = discover_subjects(
            self.inbox, ready_marker=self.ready_marker, min_age=self.min_age
        )
        now = time.time()
        # Drop bookkeeping for subjects deleted from the inbox so
        # awaiting_retry never reports ghosts.
        for sid in list(self._failed):
            if not os.path.isdir(os.path.join(self.inbox, sid)):
                del self._failed[sid]
                self._sigs.pop(sid, None)
                self._stable.pop(sid, None)
        new: List[Dict] = []
        retries: List[Dict] = []
        pre_mtimes: Dict[str, float] = {}
        for e in subjects:
            sid = e["id"]
            if sid in self._served:
                continue
            mtime, sig = _dir_state(os.path.join(self.inbox, sid))
            prev_sig = self._sigs.get(sid)
            self._sigs[sid] = sig
            changed = prev_sig is not None and sig != prev_sig
            stable = 0 if (changed or prev_sig is None) \
                else self._stable.get(sid, 0) + 1
            self._stable[sid] = stable
            if changed or stable < self.settle_scans:
                # Still changing since the last scan (a producer with
                # preserved mtimes, or an operator fixing it in place), or
                # not yet observed stable often enough: hold back.
                pending += 1
                continue
            # Record the pre-dispatch mtime so a fix dropped WHILE this
            # scan's analysis runs still reads as newer on the next scan.
            pre_mtimes[sid] = mtime
            st = self._failed.get(sid)
            if st is None:
                new.append(e)
                continue
            # Previously failed.  Re-arm immediately (fresh budget) if the
            # producer touched the study since the last attempt — "fix the
            # files in place" is the operator's natural remedy; otherwise
            # retry on the backoff schedule while budget remains.
            if mtime > st.mtime + 1e-6:
                st.attempts = 0
                retries.append(e)
            elif st.attempts <= self.max_retries and now >= st.next_retry:
                retries.append(e)
        picked = new + retries
        # Exactly-once across service restarts: a .done marker means the
        # subject's export completed in a previous life — count it resumed
        # and never re-dispatch (a FAILED subject writes metrics.json but no
        # marker, so a restart retries it, which is what an operator wants).
        done = [e for e in picked
                if os.path.exists(os.path.join(self.out_dir, e["id"],
                                               ".done"))]
        done_ids = {d["id"] for d in done}
        todo = [e for e in picked if e["id"] not in done_ids]
        results: List[Dict] = []
        if todo:
            results = run_cohort(
                todo, self.out_dir, config=self.config,
                batch_size=self.batch_size, resume=True,
                runners=self.runners, export_npz=self.export_npz,
                adaptive_pad=True, device=self._cohort_device,
                use_mesh=self.use_mesh,
            )
        # A .done marker resolves the subject terminally for this inbox
        # state — including analysis-invalid subjects (e.g. empty mask),
        # whose export IS their final result; clear any retry state so
        # awaiting_retry never reports a subject that will not be retried.
        self._served.update(done_ids)
        for sid in done_ids:
            self._failed.pop(sid, None)
            self._sigs.pop(sid, None)
            self._stable.pop(sid, None)
        analyzed = failed = 0
        for r in results:
            sid = r["id"]
            if r.get("valid"):
                analyzed += 1
                self._served.add(sid)
                self._failed.pop(sid, None)
                self._sigs.pop(sid, None)
                self._stable.pop(sid, None)
            elif os.path.exists(os.path.join(self.out_dir, sid, ".done")):
                # Invalid metrics but the export completed (analysis-stage
                # invalidity, e.g. an empty mask): that IS the subject's
                # final result under the .done protocol — terminal, not a
                # retry candidate.  Decode failures write no marker and
                # take the branch below.
                failed += 1
                self._served.add(sid)
                self._failed.pop(sid, None)
                self._sigs.pop(sid, None)
                self._stable.pop(sid, None)
            else:
                failed += 1
                st = self._failed.setdefault(sid, _FailureState())
                st.attempts += 1
                st.mtime = pre_mtimes.get(sid, 0.0)
                st.next_retry = (now + self.retry_backoff
                                 * (2 ** (st.attempts - 1)))
                if st.attempts > self.max_retries:
                    log.warning(
                        "subject %s failed %d times; waiting for the study "
                        "to change on disk before retrying", sid, st.attempts)
        report = ScanReport(
            scanned=len(subjects), new=len(new), analyzed=analyzed,
            failed=failed, resumed=len(done), pending=pending,
            retried=len(retries),
        )
        self._totals["scans"] += 1
        for k in ("analyzed", "failed", "resumed"):
            self._totals[k] += getattr(report, k)
        if picked:
            self._append_ledger(
                report,
                results + [{"id": e["id"], "resumed": True} for e in done],
            )
        self._write_status(report)
        return report

    def _write_status(self, report: Optional[ScanReport]) -> None:
        """Atomic heartbeat (`serve_status.json`): liveness + cumulative
        counters for external monitoring, rewritten after every scan
        (report=None when the scan itself errored)."""
        status = {
            "ts": time.time(),
            "started": self._started,
            "inbox": self.inbox,
            "last_scan": None if report is None else report.as_dict(),
            "last_error": self._last_error,
            "awaiting_retry": sorted(self._failed),
            "preflight": self._preflight,
            **self._totals,
        }
        tmp = os.path.join(self.out_dir, ".serve_status.tmp")
        with self._status_lock:
            with open(tmp, "w") as f:
                json.dump(status, f)
            os.replace(tmp, os.path.join(self.out_dir, "serve_status.json"))

    def _append_ledger(self, report: ScanReport, results: List[Dict]) -> None:
        """Service ledger: one JSONL record per scan that did work, so an
        operator can audit what arrived and what it measured without
        trawling per-subject directories."""
        rec = {
            "ts": time.time(),
            **report.as_dict(),
            "subjects": [
                {k: r.get(k) for k in
                 ("id", "valid", "resumed", "error", "VDP", "VDP_lb",
                  "VDP_km", "CI", "SNR")
                 if k in r}
                for r in results
            ],
        }
        with open(os.path.join(self.out_dir, "serve_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _watchdog_fire(self, scan_no: int, timeout: float,
                       exit_fn=None) -> None:
        """A scan exceeded ``scan_timeout``: the device is presumed
        wedged (the failure mode is a runtime call blocked forever in
        native code — 0 CPU, no error, unkillable from Python).
        Make the hang visible in the heartbeat, then hard-exit with
        WATCHDOG_EXIT_CODE so a process supervisor (systemd Restart=,
        docker --restart) brings up a fresh client; the .done protocol
        makes the restart exactly-once."""
        exit_fn = exit_fn or _watchdog_exit
        # NOTHING may prevent the exit: the diagnostics below race a scan
        # thread that is still mutating _failed/_sigs (e.g. sorted() over
        # a dict changing size in _write_status), and stderr/logging can
        # themselves be broken — swallow everything, exit in finally.
        try:
            self._last_error = {
                "ts": time.time(), "wedged": True,
                "error": f"watchdog: scan {scan_no} exceeded {timeout:g}s "
                         "(device presumed wedged); exiting "
                         f"{WATCHDOG_EXIT_CODE} for supervisor restart",
            }
            self._write_status(None)
            log.critical("%s", self._last_error["error"])
        except Exception:  # noqa: BLE001 — never mask the exit
            pass
        finally:
            exit_fn(WATCHDOG_EXIT_CODE)

    def serve_forever(
        self,
        interval: float = 5.0,
        stop: Optional[threading.Event] = None,
        max_scans: Optional[int] = None,
        on_scan=None,
        scan_timeout: float = 0.0,
    ) -> int:
        """Scan loop: returns the number of scans performed.

        `stop` (a threading.Event) ends the loop at the next interval
        boundary; `max_scans` bounds it for tests/one-shots; `on_scan(report)`
        is invoked after every scan (the CLI prints a JSON line there).
        `scan_timeout` > 0 arms a per-scan watchdog: a scan that runs
        longer hard-exits the process (see _watchdog_fire) — size it above
        the worst-case scan, remembering the FIRST scan of a geometry may
        include the kernels' build when none exists yet.
        """
        stop = stop or threading.Event()
        # Bind the exit seam once per loop, not at fire time: a timer
        # thread that outlives a test's monkeypatch must keep the stub it
        # was armed with, never a restored real os._exit.
        exit_fn = _watchdog_exit
        n = 0
        while not stop.is_set():
            watchdog = None
            if scan_timeout > 0:
                watchdog = threading.Timer(
                    scan_timeout, self._watchdog_fire,
                    args=(n + 1, scan_timeout, exit_fn))
                watchdog.daemon = True
                watchdog.start()
            try:
                report = self.scan_once()
            except Exception as e:  # noqa: BLE001 — daemon must outlive
                # any one scan: a transient inbox/export-I/O error (NFS
                # blip, disk full) poisons this scan only, is recorded in
                # the heartbeat, and the loop retries next interval.
                # scan_once called directly (library / --once) still
                # raises normally.
                log.exception("scan failed; service continues")
                self._totals["scan_errors"] += 1
                self._last_error = {"ts": time.time(), "error": repr(e)}
                try:
                    self._write_status(None)
                except OSError:
                    pass  # out_dir itself unavailable; heartbeat resumes
                report = None
            finally:
                if watchdog is not None:
                    # Timer.cancel() cannot recall a callback already
                    # executing: a scan finishing exactly at the deadline
                    # may still exit 86 (same irreducible window as
                    # utils/watchdog.py) — benign, the supervisor restart
                    # resumes from the inbox ledger.
                    watchdog.cancel()
            n += 1
            if report is not None:
                if report.new:
                    log.info("scan %d: %d new subject(s), %d analyzed, "
                             "%d failed", n, report.new, report.analyzed,
                             report.failed)
                if on_scan is not None:
                    on_scan(report)
            if max_scans is not None and n >= max_scans:
                break
            stop.wait(interval)
        return n
