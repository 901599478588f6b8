"""Per-subject exports of the cohort driver: NIfTI, header JSON, NPZ.

The port's copy of the reference package's export layer, for what
``pipeline/cohort.py`` writes:
- ``export_nifti``: the 6-channel float32 4-D array in the reference's
  fixed channel order [proton, HPvent, mask, N4HPvent, defectArray,
  CIarray] with an identity affine (Vent_Analysis.py:273-313);
- ``dicom_to_json``: the full header minus Pixel Data
  (Vent_Analysis.py:374-379);
- ``save_npz``: the versioned NPZ study artifact, loadable with
  ``np.load(path, allow_pickle=False)`` by either package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np

from ventjax_torch.io import dicom as dcm
from ventjax_torch.io import nifti


def build_4d_array(
    hp: np.ndarray,
    mask: np.ndarray,
    proton=None,
    n4=None,
    defect=None,
    ci=None,
) -> np.ndarray:
    """6-channel export array in the reference's fixed channel order
    [proton, HPvent, mask, N4HPvent, defectArray, CIarray]
    (Vent_Analysis.py:292-313); missing channels stay zero.

    Like the reference, each optional channel is a guarded ASSIGNMENT
    (try/except, Vent_Analysis.py:296-312): an array that numpy can
    broadcast into [H,W,D] fills the channel even when its shape differs
    (e.g. a (H,W,1) proton), and only a failing assignment leaves zeros."""
    # Fortran order (the values are the reference's): NIfTI serialises in F
    # order, so each channel fill and nifti.save's tobytes(order="F") are
    # straight copies.
    out = np.zeros((hp.shape[0], hp.shape[1], hp.shape[2], 6),
                   dtype=np.float32, order="F")
    out[:, :, :, 1] = hp
    out[:, :, :, 2] = mask
    for idx, arr in ((0, proton), (3, n4), (4, defect), (5, ci)):
        if arr is None:
            continue
        try:
            out[:, :, :, idx] = arr
        except Exception:  # noqa: BLE001 — mirrors the reference's bare
            # except (Vent_Analysis.py:296-313): ANY failing assignment
            # (shape mismatch, object dtype, exotic array-likes raising
            # arbitrary errors) leaves the channel zeroed, silently.
            pass
    return out


def export_nifti(
    filepath: str,
    file_name: str,
    hp: np.ndarray,
    mask: np.ndarray,
    proton=None,
    n4=None,
    defect=None,
    ci=None,
) -> str:
    data = build_4d_array(hp, mask, proton=proton, n4=n4, defect=defect, ci=ci)
    savepath = os.path.join(filepath, file_name + "_dataArray.nii")
    nifti.save(savepath, data, affine=np.eye(4))
    return savepath


def dicom_to_json(ds: dcm.Dataset, json_path: str,
                  include_private: bool = True) -> str:
    with open(json_path, "w") as f:
        json.dump(dcm.dicom_to_dict(ds, include_private), f, indent=4)
    return json_path


ARTIFACT_VERSION = 1
_MANIFEST_KEY = "__ventjax_artifact__"


def _json_safe(x):
    """Best-effort JSON conversion for manifest values (DICOM header values,
    numpy scalars, nested metadata dicts); anything else becomes str(x)."""
    if x is None or isinstance(x, (str, bool)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    return str(x)


def save_npz(state: Dict, npz_path: str) -> str:
    """Versioned, dependency-free study artifact, the reference package's
    format: a plain `np.savez_compressed` file with every ndarray entry as
    a named compressed array plus one JSON manifest string holding the
    metadata dict, scalar entries and the VentConfig.  It loads with
    `np.load(path, allow_pickle=False)` anywhere NumPy exists (and with the
    reference package's ``load_npz``).

    Non-array, non-scalar objects (the DICOM `ds`) are recorded by type
    name under the manifest's "skipped" key.
    """
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict = {}
    dicts: Dict = {}
    skipped: Dict[str, str] = {}
    config = None
    for key, value in state.items():
        if key == _MANIFEST_KEY:
            continue
        if isinstance(value, (np.integer, np.floating, np.bool_)):
            scalars[key] = _json_safe(value)
        elif isinstance(value, np.ndarray) or (
            hasattr(value, "__array__") and not isinstance(value, dict)
        ):
            arr = np.asarray(value)
            if arr.dtype == object:  # not loadable without allow_pickle
                skipped[key] = f"object-dtype array {arr.shape}"
            else:
                arrays[key] = arr
        elif (key == "config" and dataclasses.is_dataclass(value)
              and not isinstance(value, type)):
            # Only the VentConfig slot is a dataclass the manifest knows how
            # to restore; OTHER dataclasses (a parsed TwixScan in raw_twix,
            # say) carry ndarray fields that would crash json.dumps — they
            # are recorded as skipped like any opaque object.
            config = dataclasses.asdict(value)
        elif isinstance(value, dict):
            dicts[key] = _json_safe(value)
        elif value is None or isinstance(value, (str, bool, int, float)):
            scalars[key] = value
        elif isinstance(value, (list, tuple)):
            scalars[key] = _json_safe(value)
        else:
            skipped[key] = type(value).__name__
    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "scalars": scalars,
        "dicts": dicts,
        "config": config,
        "skipped": skipped,
    }
    # np.savez_compressed appends ".npz" to suffix-less paths; normalize
    # first so the returned path always names the file actually written.
    if not npz_path.endswith(".npz"):
        npz_path += ".npz"
    np.savez_compressed(
        npz_path, **arrays,
        **{_MANIFEST_KEY: np.asarray(json.dumps(manifest))},
    )
    return npz_path
