"""The comparison that decides ``correct``.

What the timed path produced for a sample of its calls is held to the plain
reference (``reference/pipeline.py``), run on the same inputs on the
card in float64 once the window has closed, one call's batch at a time.

From the raw inputs (the whole chain, independent of the program):

- ``snr_rel``: the widest relative gap of a study's SNR;
- ``n4_rel``: the widest relative gap of N4's corrected image over the
  lung, against the reference trajectory nearest the program's (the
  reference follows both outcomes of a convergence test within 1% of the
  threshold, where a float32 program may stop on either side);
- ``vdp_pp``: the widest gap of the three VDPs, in percentage points,
  against the same trajectory.

From the program's own output, each stage by itself (the reference reads
the program's output here only to judge the next stage):

- ``defect_mismatch``: voxels of the three defect maps that differ from
  the reference's maps of the program's N4 image, outside the voxels whose
  value is within float32 rounding of a threshold;
- ``ci_map_mm``: the widest gap of the CI map against the reference's CI
  of the program's defect map, and ``ci_subject_mm`` of the subject CI;
- ``volume_rel``: the widest relative gap of the lung and defect volumes
  against the reference's volumes of the mask and the program's defect map;
- ``repeat_diff``: elements of a sampled call's output that differ from
  the output of the same batch in set-up (the port's outputs repeat bit
  for bit), on every sampled call.

Each number has its limit in the configuration's ``fidelity``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import pipeline as R

#: A float32 program may stop N4 on either side of a convergence test this
#: close (relative) to its threshold.
N4_BAND = 0.01
MAPS = ("n4", "defect", "defect_lb", "defect_km", "ci_map")
NAMES = ("snr_rel", "n4_rel", "vdp_pp", "defect_mismatch", "ci_map_mm",
         "ci_subject_mm", "volume_rel", "repeat_diff")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs()).max())


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Widest gap, NaN against NaN counting as equal."""
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max())


def judge_batch(hp: np.ndarray, mask: np.ndarray, out: Dict, vox,
                pipe: Dict, device) -> Dict[str, float]:
    """The readings of one call's batch: ``out`` holds the program's maps
    (MAPS) and its metrics (by StudyMetrics' field names) on the host."""
    f64 = torch.float64
    hp_d = torch.as_tensor(hp, device=device)
    mask_d = torch.as_tensor(mask, device=device)
    m = mask_d > 0
    met = {k: torch.as_tensor(np.asarray(v), device=device).to(f64)
           for k, v in out["metrics"].items()}
    prog = {k: torch.as_tensor(np.asarray(out[k]), device=device).to(f64)
            for k in MAPS}
    r: Dict[str, float] = {}

    r["snr_rel"] = _rel(met["snr"], R.snr(hp_d, mask_d,
                                          pipe["snr_fov_buffer"]))

    traj, owner = R.n4(hp_d, mask_d, band=N4_BAND, **R.n4_args(pipe))
    chosen, worst = [], 0.0
    for i in range(hp.shape[0]):
        idx = torch.nonzero(owner == i).reshape(-1)
        gaps = [_rel(prog["n4"][i][m[i]], traj[j][m[i]]) for j in idx]
        best = int(np.argmin(gaps))
        worst = max(worst, gaps[best])
        chosen.append(int(idx[best]))
    r["n4_rel"] = worst
    n4_ref = traj[torch.tensor(chosen, device=device)]
    del traj
    vdps = (R.vdp_mean_anchored(n4_ref, mask_d, pipe["vdp_thresh"])[1],
            R.vdp_linear_binning(n4_ref, mask_d, pipe["lb_edges"],
                                 pipe["lb_percentile"])[1],
            R.vdp_kmeans(n4_ref, mask_d, pipe["kmeans_clusters"],
                         pipe["kmeans_iters"],
                         pipe["kmeans_defect_clusters"])[1])
    r["vdp_pp"] = max(_gap(met[k], v) for k, v in
                      zip(("vdp", "vdp_lb", "vdp_km"), vdps))

    n4p = prog["n4"]
    staged = (("defect", R.vdp_mean_anchored(n4p, mask_d,
                                             pipe["vdp_thresh"])),
              ("defect_lb", R.vdp_linear_binning(n4p, mask_d,
                                                 pipe["lb_edges"],
                                                 pipe["lb_percentile"])),
              ("defect_km", R.vdp_kmeans(n4p, mask_d, pipe["kmeans_clusters"],
                                         pipe["kmeans_iters"],
                                         pipe["kmeans_defect_clusters"])))
    r["defect_mismatch"] = float(max(
        int(((prog[k] != ref) & ~undecided).reshape(hp.shape[0], -1)
            .sum(1).max()) for k, (ref, _, undecided) in staged))

    ci_ref = R.ci_map(prog["defect"], vox, pipe["ci_rmax"])
    r["ci_map_mm"] = _gap(prog["ci_map"], ci_ref)
    r["ci_subject_mm"] = _gap(met["ci"], R.subject_ci(
        ci_ref, prog["defect"], pipe["ci_percentile"]))
    lung, dvol = R.volumes(mask_d, prog["defect"], vox)
    dgap = torch.where(dvol > 0, (met["defect_volume"] - dvol).abs()
                       / dvol.clamp_min(1e-300),
                       torch.where(met["defect_volume"] == 0,
                                   torch.zeros_like(dvol),
                                   torch.full_like(dvol, math.inf)))
    r["volume_rel"] = max(_rel(met["lung_volume"], lung), float(dgap.max()))
    return r


def repeat_diff(out: Dict, first: Dict) -> int:
    """Elements of the maps and metrics of ``out`` unlike ``first``'s, NaN
    equal to NaN."""
    pairs = [(out[k], first[k]) for k in MAPS] + [
        (v, first["metrics"][k]) for k, v in out["metrics"].items()]
    return sum(int((~np.isclose(np.asarray(a), np.asarray(b), rtol=0, atol=0,
                                equal_nan=True)).sum()) for a, b in pairs)


def judge(samples: Sequence[Tuple[np.ndarray, np.ndarray, Dict, Dict]], vox,
          pipe: Dict, limits: Dict[str, float], device
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, reading, limit)]) over ``samples``, each (hp, mask,
    the program's output, its output of the same batch in set-up), taking
    the widest reading."""
    worst = {k: 0.0 for k in NAMES}
    for hp, mask, out, first in samples:
        readings = judge_batch(hp, mask, out, vox, pipe, device)
        readings["repeat_diff"] = float(repeat_diff(out, first))
        for k, v in readings.items():
            worst[k] = max(worst[k], v) if not math.isnan(v) else math.inf
    rows = [(k, worst[k], float(limits[k])) for k in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
