"""ventjax_torch's stall watchdog (utils/watchdog.py) and its cohort CLI
plumbing: the cases of tests/test_watchdog.py on the port's copy, which
keeps ventjax's exit code and test seam."""
import json
import time

import pytest

from ventjax.utils import watchdog as jax_wd
from ventjax_torch.io.synthetic import write_study
from ventjax_torch.utils import watchdog as wd_mod
from ventjax_torch.utils.watchdog import EXIT_CODE, StallWatchdog


@pytest.fixture(scope="module")
def study_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wd_study")
    write_study(str(root), shape=(32, 32, 8), vox=(1.5, 1.5, 10.0), seed=5)
    return str(root)


def test_exit_code_is_ventjax_s():
    assert EXIT_CODE == jax_wd.EXIT_CODE == 86


def test_fires_once_after_quiet_period(monkeypatch, capfd):
    # capfd (fd-level) rather than capsys: faulthandler writes to the real
    # file descriptor, which capsys' pseudo-file does not have.
    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    with StallWatchdog(0.15, label="unit"):
        time.sleep(0.6)  # several poll intervals with no touch
    assert fired == [EXIT_CODE], "must fire exactly once, then stand down"
    err = capfd.readouterr().err
    assert "no unit progress" in err
    assert str(EXIT_CODE) in err
    assert "Thread" in err or "File" in err  # faulthandler stack dump


def test_touches_keep_it_quiet_and_exit_stops_it(monkeypatch):
    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    with StallWatchdog(0.3, label="unit") as wd:
        for _ in range(6):
            time.sleep(0.1)
            wd.touch()
    # Past the context the thread is stopped: even a long quiet period
    # cannot fire it.
    time.sleep(0.5)
    assert fired == []


def test_completion_during_diagnostics_stands_down(monkeypatch, capfd):
    """A run that completes while the watchdog prints its stack dump is
    not hard-exited: the post-diagnostics _stop re-check stands down."""
    import faulthandler

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    wd = StallWatchdog(0.15, label="unit")
    real_dump = faulthandler.dump_traceback

    def dump_and_complete(*a, **k):
        real_dump(*a, **k)
        wd._stop.set()  # the run finishes mid-diagnostics

    monkeypatch.setattr(faulthandler, "dump_traceback", dump_and_complete)
    with wd:
        time.sleep(0.6)  # quiet past the timeout: diagnostics fire
    time.sleep(0.2)
    assert fired == [], "completion during diagnostics must stand down"
    assert "no unit progress" in capfd.readouterr().err


def test_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        StallWatchdog(0.0)


def test_exit_seam_bound_at_construction(monkeypatch):
    """A watchdog keeps the exit function it was built with, even after
    the module's seam is restored."""
    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    wd = StallWatchdog(0.1, label="unit")
    monkeypatch.undo()
    assert wd._exit_fn == fired.append


def test_exit_survives_broken_stderr(monkeypatch):
    """A dead stderr pipe (BrokenPipeError from the diagnostic print) never
    prevents the hard exit."""
    import sys

    class DeadPipe:
        def write(self, *a):
            raise BrokenPipeError("log collector died")

        def flush(self):
            raise BrokenPipeError("log collector died")

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    monkeypatch.setattr(sys, "stderr", DeadPipe())
    with StallWatchdog(0.1, label="unit"):
        time.sleep(0.5)
    assert fired == [EXIT_CODE]


def _manifest(study_root, tmp_path):
    manifest = [{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                 "mask": f"{study_root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    return mpath


def test_cli_cohort_stall_timeout_fires_on_wedged_run(
        study_root, tmp_path, monkeypatch, capsys):
    """A run_cohort that goes quiet past --stall-timeout trips the
    watchdog (stubbed exit observed)."""
    from ventjax_torch.cli import main
    from ventjax_torch.pipeline import cohort as cohort_mod

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    monkeypatch.setattr(cohort_mod, "run_cohort",
                        lambda *a, **k: time.sleep(0.8) or [])
    (tmp_path / "o").mkdir()  # the real run_cohort would create it
    rc = main(["cohort", "--manifest", _manifest(study_root, tmp_path),
               "--out", str(tmp_path / "o"), "--max-defect", "1024",
               "--stall-timeout", "0.2", "--device", "cpu"])
    assert rc == 0  # stubbed exit lets the (stub) run finish
    assert fired == [EXIT_CODE]
    assert "no cohort progress" in capsys.readouterr().err


def test_cli_cohort_stall_timeout_quiet_on_healthy_run(
        study_root, tmp_path, monkeypatch, capsys):
    from ventjax_torch.cli import main

    fired = []
    monkeypatch.setattr(wd_mod, "_exit", fired.append)
    rc = main(["cohort", "--manifest", _manifest(study_root, tmp_path),
               "--out", str(tmp_path / "o"), "--max-defect", "1024",
               "--stall-timeout", "600", "--device", "cpu"])
    assert rc == 0
    assert fired == []
    summary = json.loads(capsys.readouterr().out)
    assert summary["valid"] == 1
