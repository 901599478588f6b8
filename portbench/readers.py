"""Helpers that the per-layer metric readers (``metrics/*.py``) share.

A reader is ``read(ctx) -> float or None``; ``ctx`` holds the traced window
(``trace``: a ``devtrace.Trace``), its calls' pool batches (``calls``) and
studies, the program's counters over the traced window (``counts``) and
over the measured one (``window_counts``, ``window_calls``), and
``work(batch)``, what ``kernels/work.py`` reads for one pool batch.  A
reader that finds nothing to read returns None and the metric is left out
of the line.
"""
from __future__ import annotations

from typing import Optional

from portbench.harness import kernel_specs
from portbench.kernels import work as kernel_work


def roofline(ctx, kernel: str) -> Optional[float]:
    """Percent of its roofline that kernel ``kernel`` reached in the traced
    window: the least time its launches' work needs
    (``kernels/<kernel>.json`` names the activities and the work count)
    over the device time of its activities."""
    spec = kernel_specs(ctx.root)[kernel]
    seconds, n = ctx.trace.device_seconds(spec["match"])
    if n == 0 or seconds <= 0:
        return None
    count = getattr(kernel_work, spec["work"])
    least = {b: count(ctx.work(b), spec) for b in set(ctx.calls)}
    return 100.0 * sum(least[b] for b in ctx.calls) / seconds


def stage_ms(ctx, name: str) -> Optional[float]:
    """Host milliseconds a call spent inside the program's ``name`` range."""
    s = ctx.trace.host_seconds(name)
    return 1e3 * s / len(ctx.calls) if s > 0 else None
