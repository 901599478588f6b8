"""ventjax_torch's watch-folder daemon (pipeline/serve.py) on the CPU: the
cases of tests/test_serve.py on the port (``device="cpu"``), and one inbox
through ventjax's WatchService and the port's side by side.

Tolerances: the ScanReports, the .done sets, awaiting_retry and the ids,
validity and errors of the service ledgers equal; the VDPs of the ledgers
within 0.1 percentage points (the two N4s differ within the bf16-fit
envelope, as in tests/test_torch_cohort.py).  Studies are 32x32x8 with a
short N4, written once per module where a test only reads them.
"""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io.synthetic import (
    write_mask_folder, write_multiframe, write_study,
)
from ventjax_torch.pipeline import serve as serve_mod
from ventjax_torch.pipeline.serve import WatchService, discover_subjects

torch.set_num_threads(2)

SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)
FAST_KW = dict(ci_max_defect_voxels=512, ci_rmax=16, n4_fitting_levels=2,
               n4_max_iters=5)
FAST = DEFAULT_CONFIG.replace(**FAST_KW)


def _age(root, seconds=3600):
    """Back-date every file so min_age gating sees a settled subject."""
    past = time.time() - seconds
    for r, _d, files in os.walk(root):
        for f in files:
            os.utime(os.path.join(r, f), (past, past))


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """Written studies by seed, copied into an inbox by _drop."""
    root = tmp_path_factory.mktemp("serve_studies")
    out = {}
    for seed in (1, 2, 10, 11, 12, 20, 30, 40, 50, 60):
        write_study(str(root / f"seed{seed}"), shape=SHAPE, vox=VOX,
                    seed=seed, with_proton=seed == 2)
        out[seed] = str(root / f"seed{seed}")
    return out


def _drop(studies, inbox, sid, seed, old=True):
    root = os.path.join(str(inbox), sid)
    shutil.copytree(studies[seed], root)
    if old:
        _age(root)
    else:
        now = time.time()
        for r, _d, files in os.walk(root):
            for f in files:
                os.utime(os.path.join(r, f), (now, now))
    return root


def _junk(inbox, sid, payload=b"\x00" * 256):
    bad = os.path.join(str(inbox), sid)
    os.makedirs(os.path.join(bad, "mask"))
    with open(os.path.join(bad, "xenon.dcm"), "wb") as f:
        f.write(payload)  # not a DICOM
    _age(bad)
    return bad


def _svc(inbox, out, **kw):
    kw.setdefault("min_age", 30.0)
    return WatchService(str(inbox), str(out), config=FAST, device="cpu",
                        **kw)


# ---------------------------------------------------------------- discovery

def test_discover_layout_and_gating(studies, tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    _drop(studies, inbox, "s1", 1)
    os.makedirs(inbox / "half" / "mask_not_yet", exist_ok=True)
    (inbox / "half" / "xenon.dcm").write_bytes(b"partial")
    (inbox / "README.txt").write_text("not a subject")

    subjects, pending = discover_subjects(str(inbox), min_age=0.0)
    assert [e["id"] for e in subjects] == ["s1"]
    assert pending == 1
    assert subjects[0]["xenon"].endswith(os.path.join("s1", "xenon.dcm"))
    assert "proton" not in subjects[0]

    _drop(studies, inbox, "s2", 2)   # written with a proton
    subjects, _ = discover_subjects(str(inbox), min_age=0.0)
    by_id = {e["id"]: e for e in subjects}
    assert by_id["s2"]["proton"].endswith("proton.dcm")


def test_discover_min_age_gates_fresh_files(studies, tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    _drop(studies, inbox, "fresh", 1, old=False)
    subjects, pending = discover_subjects(str(inbox), min_age=30.0)
    assert subjects == [] and pending == 1
    _age(str(inbox / "fresh"))
    subjects, pending = discover_subjects(str(inbox), min_age=30.0)
    assert [e["id"] for e in subjects] == ["fresh"] and pending == 0


def test_discover_ready_marker_wins_over_age(studies, tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    _drop(studies, inbox, "s1", 1, old=False)
    subjects, pending = discover_subjects(str(inbox), ready_marker="READY")
    assert subjects == [] and pending == 1
    (inbox / "s1" / "READY").write_text("")
    subjects, pending = discover_subjects(str(inbox), ready_marker="READY")
    assert [e["id"] for e in subjects] == ["s1"] and pending == 0


def test_discover_missing_inbox_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="inbox"):
        discover_subjects(str(tmp_path / "nope"))


def test_service_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    (tmp_path / "inbox").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        WatchService(str(tmp_path / "inbox"), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------- serving loop

def test_serve_incremental_scans_with_warm_runners(studies, tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _drop(studies, inbox, "a", 10)
    _drop(studies, inbox, "b", 11)

    svc = _svc(inbox, out)
    r1 = svc.scan_once()
    assert (r1.new, r1.analyzed, r1.failed, r1.pending) == (2, 2, 0, 0)
    for sid in ("a", "b"):
        assert (out / sid / ".done").exists()
        m = json.loads((out / sid / "metrics.json").read_text())
        assert m["valid"] and np.isfinite(m["VDP"])

    mtime_a = (out / "a" / "metrics.json").stat().st_mtime
    r2 = svc.scan_once()
    assert (r2.new, r2.analyzed) == (0, 0) and r2.scanned == 2
    assert (out / "a" / "metrics.json").stat().st_mtime == mtime_a

    # A third subject of the same geometry reuses the persistent runner and
    # its cached configs and CI geometries.
    runner = next(iter(svc.runners.values()))
    cfgs_before = dict(runner._cfgs)
    _drop(studies, inbox, "c", 12)
    r3 = svc.scan_once()
    assert (r3.new, r3.analyzed) == (1, 1)
    assert (out / "c" / ".done").exists()
    assert len(svc.runners) == 1
    assert next(iter(svc.runners.values())) is runner
    for key, entry in cfgs_before.items():
        assert runner._cfgs[key] is entry

    lines = [json.loads(x) for x in
             (out / "serve_log.jsonl").read_text().splitlines()]
    assert [rec["new"] for rec in lines] == [2, 1]
    assert {s["id"] for s in lines[0]["subjects"]} == {"a", "b"}
    assert all(np.isfinite(s["VDP"]) for s in lines[0]["subjects"])


def test_serve_restart_resumes_exactly_once(studies, tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _drop(studies, inbox, "a", 20)
    assert _svc(inbox, out).scan_once().analyzed == 1
    nifti_mtime = next((out / "a").glob("*.nii")).stat().st_mtime

    svc2 = _svc(inbox, out)
    r = svc2.scan_once()
    assert (r.new, r.resumed, r.analyzed, r.failed) == (1, 1, 0, 0)
    assert next((out / "a").glob("*.nii")).stat().st_mtime == nifti_mtime
    assert svc2.scan_once().new == 0


def test_serve_corrupt_subject_isolated(studies, tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _drop(studies, inbox, "good", 30)
    _junk(inbox, "bad")

    r = _svc(inbox, out).scan_once()
    assert (r.new, r.analyzed, r.failed) == (2, 1, 1)
    assert json.loads((out / "good" / "metrics.json").read_text())["valid"]
    badm = json.loads((out / "bad" / "metrics.json").read_text())
    assert badm["valid"] is False and badm["error"] == "decode_failed"
    svc2 = _svc(inbox, out)
    r2 = svc2.scan_once()
    assert (r2.resumed, r2.failed, r2.analyzed) == (1, 1, 0)


def test_serve_retry_budget_and_rearm(studies, tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    bad = _junk(inbox, "flaky")

    svc = _svc(inbox, out, max_retries=1, retry_backoff=0.0)
    r1 = svc.scan_once()
    assert (r1.new, r1.failed, r1.retried) == (1, 1, 0)
    r2 = svc.scan_once()
    assert (r2.new, r2.failed, r2.retried) == (0, 1, 1)
    r3 = svc.scan_once()
    assert (r3.failed, r3.retried) == (0, 0)
    status = json.loads((out / "serve_status.json").read_text())
    assert status["awaiting_retry"] == ["flaky"]
    assert status["scans"] == 3 and status["failed"] == 2

    # Fixing the study in place (newer mtimes) re-arms it: held back one
    # scan (signature changed), analysed on the next.
    os.unlink(os.path.join(bad, "xenon.dcm"))
    write_study(bad, shape=SHAPE, vox=VOX, seed=77, with_proton=False)
    _age(bad, seconds=100)
    r4 = svc.scan_once()
    assert (r4.retried, r4.analyzed, r4.pending) == (0, 0, 1)
    r5 = svc.scan_once()
    assert (r5.retried, r5.analyzed, r5.failed) == (1, 1, 0)
    assert (out / "flaky" / ".done").exists()
    status = json.loads((out / "serve_status.json").read_text())
    assert status["awaiting_retry"] == [] and status["analyzed"] == 1


def test_serve_retry_backoff_delays_attempt(tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _junk(inbox, "bad", b"junk")
    svc = _svc(inbox, out, max_retries=3, retry_backoff=3600.0)
    assert svc.scan_once().failed == 1
    r = svc.scan_once()
    assert (r.retried, r.failed) == (0, 0)


def test_serve_settle_scans_gates_preserved_mtime_copy(studies, tmp_path):
    """settle_scans=1 requires one confirming scan with an unchanged file
    signature before first pickup."""
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _drop(studies, inbox, "s1", 50)
    svc = _svc(inbox, out, settle_scans=1)
    r1 = svc.scan_once()
    assert (r1.analyzed, r1.pending) == (0, 1)
    (inbox / "s1" / "proton.dcm").write_bytes(b"placeholder")
    _age(str(inbox / "s1"))
    r2 = svc.scan_once()
    assert (r2.analyzed, r2.pending) == (0, 1)
    write_multiframe(str(inbox / "s1" / "proton.dcm"),
                     np.ones(SHAPE, np.float32), VOX)
    _age(str(inbox / "s1"))
    r3 = svc.scan_once()
    assert (r3.analyzed, r3.pending) == (0, 1)
    r4 = svc.scan_once()
    assert (r4.analyzed, r4.failed) == (1, 0)
    assert (out / "s1" / ".done").exists()


def test_serve_invalid_with_done_is_terminal(studies, tmp_path):
    """An empty mask exports with a .done marker: terminal, counted failed
    once, never queued for retry."""
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    root = _drop(studies, inbox, "emptymask", 60)
    shutil.rmtree(os.path.join(root, "mask"))
    write_mask_folder(os.path.join(root, "mask"), np.zeros(SHAPE), VOX)
    _age(root)
    svc = _svc(inbox, out, max_retries=5, retry_backoff=0.0)
    r1 = svc.scan_once()
    assert (r1.new, r1.failed) == (1, 1)
    m = json.loads((out / "emptymask" / "metrics.json").read_text())
    assert m["valid"] is False
    assert (out / "emptymask" / ".done").exists()
    status = json.loads((out / "serve_status.json").read_text())
    assert status["awaiting_retry"] == []
    r2 = svc.scan_once()
    assert (r2.retried, r2.failed) == (0, 0)


def test_serve_deleted_failed_subject_pruned(tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    bad = _junk(inbox, "gone", b"junk")
    svc = _svc(inbox, out, max_retries=0, retry_backoff=3600.0)
    assert svc.scan_once().failed == 1
    shutil.rmtree(bad)
    svc.scan_once()
    status = json.loads((out / "serve_status.json").read_text())
    assert status["awaiting_retry"] == []


def test_serve_forever_survives_scan_errors(tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    svc = _svc(inbox, out)
    calls = {"n": 0}
    real_scan = svc.scan_once

    def flaky_scan():
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("transient NFS blip")
        return real_scan()

    svc.scan_once = flaky_scan
    reports = []
    n = svc.serve_forever(interval=0.01, max_scans=3, on_scan=reports.append)
    assert n == 3 and len(reports) == 2
    status = json.loads((out / "serve_status.json").read_text())
    assert status["scan_errors"] == 1
    assert "NFS blip" in status["last_error"]["error"]
    svc.scan_once = real_scan
    shutil.rmtree(inbox)
    with pytest.raises(FileNotFoundError):
        svc.scan_once()


def test_serve_forever_stops_and_counts(tmp_path):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    svc = _svc(inbox, tmp_path / "out")
    reports = []
    n = svc.serve_forever(interval=0.01, max_scans=3, on_scan=reports.append)
    assert n == 3 and len(reports) == 3
    assert all(r.new == 0 for r in reports)

    stop = threading.Event()
    done = {}

    def run():
        done["n"] = svc.serve_forever(interval=0.01, stop=stop)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.15)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and done["n"] >= 1


# ----------------------------------------------------- preflight, watchdog

def _stub_doctor(ok):
    return lambda full=False, tmp_dir=None, device="cuda": {
        "ok": ok, "full": False,
        "checks": [{"name": "device_probe", "ok": ok, "required": True}]}


def test_preflight_recorded_in_status(tmp_path, monkeypatch):
    from ventjax_torch.utils import doctor as doctor_mod

    inbox = tmp_path / "inbox"
    inbox.mkdir()
    svc = _svc(inbox, tmp_path / "out")
    monkeypatch.setattr(doctor_mod, "run_doctor", _stub_doctor(True))
    assert svc.preflight()["ok"]
    status = json.load(open(tmp_path / "out" / "serve_status.json"))
    assert status["preflight"]["ok"] is True
    assert status["preflight"]["failed"] == []

    monkeypatch.setattr(doctor_mod, "run_doctor", _stub_doctor(False))
    assert not svc.preflight()["ok"]
    status = json.load(open(tmp_path / "out" / "serve_status.json"))
    assert status["preflight"]["failed"] == ["device_probe"]


def test_preflight_runs_the_doctor_on_the_service_device(tmp_path,
                                                         monkeypatch):
    from ventjax_torch.utils import doctor as doctor_mod

    seen = []
    monkeypatch.setattr(doctor_mod, "run_doctor",
                        lambda **kw: seen.append(kw) or _stub_doctor(True)())
    (tmp_path / "inbox").mkdir()
    _svc(tmp_path / "inbox", tmp_path / "out").preflight()
    assert seen == [{"device": torch.device("cpu")}]


def test_watchdog_fires_on_wedged_scan(tmp_path, monkeypatch):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    svc = _svc(inbox, tmp_path / "out")
    fired = []
    monkeypatch.setattr(serve_mod, "_watchdog_exit", fired.append)
    monkeypatch.setattr(svc, "scan_once", lambda: time.sleep(1.0))
    svc.serve_forever(interval=0.01, max_scans=1, scan_timeout=0.15)
    assert fired == [serve_mod.WATCHDOG_EXIT_CODE] == [86]
    status = json.load(open(tmp_path / "out" / "serve_status.json"))
    assert status["last_error"]["wedged"] is True
    assert "watchdog" in status["last_error"]["error"]


def test_watchdog_quiet_on_healthy_scans(tmp_path, monkeypatch):
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    svc = _svc(inbox, tmp_path / "out")
    fired = []
    monkeypatch.setattr(serve_mod, "_watchdog_exit", fired.append)
    calls = []
    real = WatchService.scan_once.__get__(svc)

    def fast_scan():
        calls.append(1)
        if len(calls) == 2:  # a failing scan must also disarm its timer
            raise OSError("transient inbox blip")
        return real()

    monkeypatch.setattr(svc, "scan_once", fast_scan)
    n = svc.serve_forever(interval=0.01, max_scans=3, scan_timeout=0.2)
    assert n == 3 and len(calls) == 3
    time.sleep(0.4)  # a leaked 0.2s timer would fire well within this
    assert fired == []
    status = json.load(open(tmp_path / "out" / "serve_status.json"))
    assert status["scan_errors"] == 1


def test_prewarm_warms_runner_for_real_arrival(studies, tmp_path):
    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    svc = _svc(inbox, out, min_age=0.0)
    svc.prewarm([(SHAPE, VOX)])
    key = (SHAPE, tuple(float(v) for v in VOX))
    assert key in svc.runners
    runner = svc.runners[key]
    assert runner._cfgs, "prewarm must have built a geometry"
    cfgs_before = dict(runner._cfgs)
    assert not (out / "warm0").exists()

    _drop(studies, inbox, "s1", 11)
    assert svc.scan_once().analyzed == 1
    assert svc.runners[key] is runner
    for k, entry in cfgs_before.items():
        assert runner._cfgs[k] is entry


# --------------------------------------------------------------------- CLI

def test_cli_serve_once(studies, tmp_path):
    import io
    from contextlib import redirect_stdout

    from ventjax_torch.cli import main

    inbox, out = tmp_path / "inbox", tmp_path / "out"
    inbox.mkdir()
    _drop(studies, inbox, "s1", 40)
    args = ["serve", "--inbox", str(inbox), "--out", str(out), "--once",
            "--min-age", "30", "--max-defect", "512", "--device", "cpu"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(args)
    assert rc == 0
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rep["new"] == 1 and rep["analyzed"] == 1 and rep["failed"] == 0
    assert (out / "s1" / ".done").exists()

    _junk(inbox, "bad", b"junk")
    with redirect_stdout(io.StringIO()):
        assert main(args) == 1


def test_cli_serve_preflight_blocks_broken_install(studies, tmp_path,
                                                   monkeypatch, capsys):
    from ventjax_torch.cli import main
    from ventjax_torch.utils import doctor as doctor_mod

    inbox = tmp_path / "inbox"
    inbox.mkdir()
    _drop(studies, inbox, "s1", 40)
    monkeypatch.setattr(doctor_mod, "run_doctor", _stub_doctor(False))
    rc = main(["serve", "--inbox", str(inbox), "--out", str(tmp_path / "o"),
               "--once", "--preflight", "--device", "cpu"])
    assert rc == 2
    assert "preflight failed" in capsys.readouterr().err
    assert not (tmp_path / "o" / "s1").exists()


def test_cli_startup_watchdog_covers_preflight_wedge(tmp_path, monkeypatch):
    from ventjax_torch.cli import main
    from ventjax_torch.utils import doctor as doctor_mod
    from ventjax_torch.utils import watchdog as wd_mod

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)

    def wedged_doctor(**kw):
        time.sleep(1.0)  # "blocked" long past the 0.2s budget
        return {"ok": True, "full": False, "checks": []}

    monkeypatch.setattr(doctor_mod, "run_doctor", wedged_doctor)
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    rc = main(["serve", "--inbox", str(inbox), "--out", str(tmp_path / "o"),
               "--once", "--preflight", "--scan-timeout", "0.2",
               "--device", "cpu"])
    assert fired == [wd_mod.EXIT_CODE]
    assert rc == 0


# ------------------------------------------------- the port against ventjax

def test_serve_matches_ventjax(studies, tmp_path):
    """One inbox (two studies and one that does not decode) through
    ventjax's WatchService and the port's, two scans each (the failed study
    is retried on the second)."""
    from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
    from ventjax.pipeline.serve import WatchService as JaxWatchService

    inbox = tmp_path / "inbox"
    inbox.mkdir()
    _drop(studies, inbox, "a", 10)
    _drop(studies, inbox, "b", 20)
    _junk(inbox, "bad")
    kw = dict(min_age=30.0, max_retries=2, retry_backoff=0.0)
    ref = JaxWatchService(str(inbox), str(tmp_path / "ref"),
                          config=JAX_DEFAULT_CONFIG.replace(**FAST_KW),
                          use_mesh=False, **kw)
    port = _svc(inbox, tmp_path / "port", **kw)
    for _ in range(2):
        assert port.scan_once().as_dict() == ref.scan_once().as_dict()

    def outcome(out):
        out = str(out)
        done = {s for s in os.listdir(out)
                if os.path.exists(os.path.join(out, s, ".done"))}
        status = json.load(open(os.path.join(out, "serve_status.json")))
        log = [json.loads(x) for x in
               open(os.path.join(out, "serve_log.jsonl"))]
        return done, status, log

    done_p, status_p, log_p = outcome(tmp_path / "port")
    done_r, status_r, log_r = outcome(tmp_path / "ref")
    assert done_p == done_r == {"a", "b"}
    assert status_p["awaiting_retry"] == status_r["awaiting_retry"] == ["bad"]
    for k in ("scans", "analyzed", "failed", "resumed", "scan_errors"):
        assert status_p[k] == status_r[k], k
    assert len(log_p) == len(log_r) == 2
    for rec_p, rec_r in zip(log_p, log_r):
        by_id = {s["id"]: s for s in rec_r["subjects"]}
        assert {s["id"] for s in rec_p["subjects"]} == set(by_id)
        for s in rec_p["subjects"]:
            want = by_id[s["id"]]
            assert s.get("valid") == want.get("valid")
            assert s.get("error") == want.get("error")
            for k in ("VDP", "VDP_lb", "VDP_km"):
                if k in want:
                    assert abs(s[k] - want[k]) < 0.1, (s["id"], k)
