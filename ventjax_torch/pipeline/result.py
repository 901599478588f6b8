"""Result dataclasses of the fused pipeline.

Counterpart of ``ventjax/pipeline/result.py``, with the same field names and
``as_dict`` keys.  Fields are tensors, one entry per lane when batched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class StudyMetrics:
    snr: torch.Tensor
    vdp: torch.Tensor
    vdp_lb: torch.Tensor
    vdp_km: torch.Tensor
    lung_volume: torch.Tensor      # liters
    defect_volume: torch.Tensor    # liters
    ci: torch.Tensor               # mm (95th pct of CI map over defect voxels)
    ci_saturated: torch.Tensor     # count of voxels clamped at Rmax
    ci_overflow: torch.Tensor      # bool: defect voxels exceeded static pad
    n4_overflow: torch.Tensor      # bool: masked voxels exceeded the N4 pad
    valid: torch.Tensor            # bool: subject had a nonempty mask

    def as_dict(self) -> dict:
        """Reference-metadata-compatible key mapping (one subject)."""
        return {
            "SNR": float(self.snr),
            "VDP": float(self.vdp),
            "VDP_lb": float(self.vdp_lb),
            "VDP_km": float(self.vdp_km),
            "LungVolume": float(self.lung_volume),
            "DefectVolume": float(self.defect_volume),
            "CI": float(self.ci),
            "CI_saturated_voxels": int(self.ci_saturated),
            "CI_overflow": bool(self.ci_overflow),
            "N4_overflow": bool(self.n4_overflow),
            "valid": bool(self.valid),
        }


@dataclasses.dataclass
class VentResult:
    """Study outputs (one subject, or batched along dim 0).

    ``export`` (``export_compact=True``) holds the compact-transfer pack:
    {"n4_cv": n4 at the mask-compaction indices, "phi": the flat B-spline
    lattices}.
    """
    n4: torch.Tensor
    defect: torch.Tensor
    defect_lb: torch.Tensor
    defect_km: torch.Tensor
    defect_border: torch.Tensor
    ci_map: torch.Tensor
    metrics: StudyMetrics
    export: Optional[dict] = None
