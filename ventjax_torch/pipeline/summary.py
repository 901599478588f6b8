"""Cohort-level aggregate summary.

The port's copy of ``ventjax/pipeline/summary.py`` (pure Python, the same
statistics and report shape).

The reference analyzes one subject at a time and has no cohort concept at
all (SURVEY.md §2.3 — the GUI even deletes the previous instance,
Vent_Analysis.py:856-858); per-subject metrics end in one JSON/pickle each.
A batched framework owes the user the aggregate view: this module reduces a
cohort's per-subject result dicts (pipeline.cohort.run_cohort output /
metrics.json contents) to distribution statistics per metric plus an
explicit accounting of every subject that is NOT in those statistics
(decode failures, empty-mask lanes, overflow flags), so a clean-looking
mean can never silently hide a failed lane.
"""
from __future__ import annotations

import math
from typing import Dict, List

#: metrics aggregated across subjects (StudyMetrics.as_dict keys)
METRIC_KEYS = ("SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume",
               "DefectVolume", "CI")


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile on pre-sorted values (numpy default)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def cohort_summary(results: List[Dict]) -> Dict:
    """Aggregate per-subject result dicts into one cohort summary dict.

    Returns::

        {"subjects": N, "valid": n_ok, "resumed_without_metrics": [ids],
         "failed": [{"id", "error"}...],
         "flags": {"ci_overflow": [ids], "n4_overflow": [ids],
                   "ci_saturated": [ids]},
         "metrics": {key: {"n", "mean", "std", "min", "p5", "median",
                           "p95", "max"}}}

    A metric's statistics cover only valid subjects with a finite value for
    that metric (CI is NaN when a subject has zero defect voxels — those
    subjects are counted in `metrics.CI.nan` rather than averaged in).
    """
    failed = []
    resumed = []
    flags = {"ci_overflow": [], "n4_overflow": [], "ci_saturated": []}
    valid_rows = []
    for r in results:
        sid = r.get("id", "?")
        if r.get("resumed") and "VDP" not in r:
            resumed.append(sid)
            continue
        if not r.get("valid"):
            failed.append({"id": sid, "error": r.get("error", "invalid")})
            continue
        valid_rows.append(r)
        if r.get("CI_overflow"):
            flags["ci_overflow"].append(sid)
        if r.get("N4_overflow"):
            flags["n4_overflow"].append(sid)
        if r.get("CI_saturated_voxels"):
            flags["ci_saturated"].append(sid)

    metrics: Dict[str, Dict] = {}
    for key in METRIC_KEYS:
        vals, nan_count = [], 0
        for r in valid_rows:
            if key not in r:
                continue
            v = float(r[key])
            if math.isfinite(v):
                vals.append(v)
            else:
                nan_count += 1
        if not vals and not nan_count:
            continue
        entry: Dict = {"n": len(vals)}
        if nan_count:
            entry["nan"] = nan_count
        if vals:
            vals.sort()
            n = len(vals)
            mean = sum(vals) / n
            entry.update({
                "mean": mean,
                "std": math.sqrt(sum((v - mean) ** 2 for v in vals) / n),
                "min": vals[0],
                "p5": _percentile(vals, 5.0),
                "median": _percentile(vals, 50.0),
                "p95": _percentile(vals, 95.0),
                "max": vals[-1],
            })
        metrics[key] = entry

    return {
        "subjects": len(results),
        "valid": len(valid_rows),
        "resumed_without_metrics": resumed,
        "failed": failed,
        "flags": flags,
        "metrics": metrics,
    }
