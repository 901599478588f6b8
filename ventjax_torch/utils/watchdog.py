"""Progress-based stall watchdog for device-bound batch runs.

The port's copy of ``ventjax/utils/watchdog.py``: the same class, exit code
and test seam, so a supervisor treats both packages' runs alike.

The documented failure mode of this class of deployment is a wedged
device runtime: a client call blocks forever inside native code — zero
CPU, no error, no Python frames to unwind — so neither an exception
handler nor a cross-thread ``sys.exit`` can recover the process (the
reference app, being attended, never needed this: an analyst just kills
the window, Vent_Analysis.py:856-864).  For unattended batch runs the
remedy is to make the hang visible and self-terminating: dump every
thread's stack for forensics, then hard-exit with a distinctive code so
a process supervisor or job scheduler restarts the run — the cohort
driver's .done markers make that restart exactly-once.

``python -m ventjax_torch serve`` has a per-scan variant
(pipeline/serve.py); this one is progress-based for offline runs where one
"scan" is the whole job.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

#: Exit code used by every watchdog of either package (also
#: pipeline/serve.py) so a supervisor can tell "wedged, restart me" from
#: real failures.
EXIT_CODE = 86

# Test seam: hard exit is the production behavior (see module docstring);
# tests replace this to observe the firing instead of dying.
_exit = os._exit


class StallWatchdog:
    """Hard-exit the process when ``touch()`` goes quiet for ``timeout`` s.

    Use as a context manager around the run and call ``touch()`` from its
    progress callbacks::

        with StallWatchdog(1800, label="cohort") as wd:
            run_cohort(..., progress=lambda *a: wd.touch())

    Size ``timeout`` above the longest legitimate gap between progress
    events — in particular the first analyze event of a geometry builds
    the CUDA kernels (nvcc) when no build of them exists yet.
    """

    def __init__(self, timeout: float, label: str = "run"):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be positive")
        self.timeout = timeout
        self.label = label
        # Bind the exit seam NOW, not at fire time: a watchdog thread that
        # outlives a test's monkeypatch must keep calling the stub it was
        # built with, never a restored real os._exit.
        self._exit_fn = _exit
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name=f"ventjax_torch-watchdog-{label}",
            daemon=True)

    def touch(self) -> None:
        """Record progress (thread-safe: a monotonic float store)."""
        self._last = time.monotonic()

    def __enter__(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()

    def _watch(self) -> None:
        poll = max(min(self.timeout / 4.0, 5.0), 0.05)
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle >= self.timeout:
                if self._stop.is_set():
                    return  # run completed while we were deciding
                # NOTHING may prevent reaching the exit decision: stderr can
                # be a dead pipe (BrokenPipeError from print) — swallow
                # every diagnostic failure.
                try:
                    print(
                        f"ventjax_torch watchdog: no {self.label} progress "
                        f"for {idle:.1f}s (device presumed wedged); "
                        f"thread stacks follow; exiting {EXIT_CODE} for "
                        "supervisor restart (completed subjects resume "
                        "from .done markers)",
                        file=sys.stderr, flush=True)
                    faulthandler.dump_traceback(file=sys.stderr)
                except Exception:  # noqa: BLE001 — never mask the exit
                    pass
                # Re-check after the (slow) diagnostics: a run that
                # completed while the stacks printed stands down — the
                # printed stacks are noise but the spurious restart is
                # avoided.  A completion landing between this check and
                # _exit_fn still exits 86; that residual window is
                # irreducible for a hard watchdog and benign (.done
                # markers make the supervisor restart a no-op).
                if self._stop.is_set():
                    return
                self._stop.set()  # fire exactly once (test exit stubs return)
                self._exit_fn(EXIT_CODE)
