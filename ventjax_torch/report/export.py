"""Export layer: NIfTI / JSON / defect-overlay DICOM / NPZ / pickle.

The port's copy of the reference package's export layer
(``ventjax/report/export.py``), for what ``pipeline/cohort.py`` and the
``Vent_Analysis`` facade write:
- ``export_nifti``: the 6-channel float32 4-D array in the reference's
  fixed channel order [proton, HPvent, mask, N4HPvent, defectArray,
  CIarray] with an identity affine (Vent_Analysis.py:273-313);
- ``dicom_to_json``: the full header minus Pixel Data
  (Vent_Analysis.py:374-379);
- ``export_dicom``: grayscale N4 with defect voxels painted pure red, one
  RGB DICOM per slice with fresh SOP/Series UIDs (forPACS=True) or one
  multi-frame RGB DICOM (Vent_Analysis.py:381-428);
- ``save_npz`` / ``load_npz``: the versioned NPZ study artifact, loadable
  with ``np.load(path, allow_pickle=False)`` by either package;
- ``save_pickle`` / ``load_pickle``: the study-state pickle, the
  reference's checkpoint format (Vent_Analysis.py:542-559).  A pickle
  written by the reference package names its classes under ``ventjax.``;
  ``load_pickle`` reads them as the port's copies of the same names, so
  it loads without importing that package (or JAX).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import warnings
from typing import Dict, Optional

import numpy as np

from ventjax_torch.io import dicom as dcm
from ventjax_torch.io import nifti
from ventjax_torch.oracle.reference import normalize


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


def _defect_rgb(n4: np.ndarray, defect: np.ndarray) -> np.ndarray:
    """uint8 RGB stack: normalized |N4| gray, defect voxels pure red
    (Vent_Analysis.py:387-391)."""
    bw = (normalize(np.abs(n4)) * 255).astype(np.uint8)
    rgb = np.zeros((*n4.shape, 3), np.uint8)
    rgb[..., 0] = bw * (defect == 0) + 255 * (defect == 1)
    rgb[..., 1] = bw * (defect == 0)
    rgb[..., 2] = bw * (defect == 0)
    return rgb


def export_dicom(
    ds: dcm.Dataset,
    n4: np.ndarray,
    defect: np.ndarray,
    save_dir: str,
    optional_text: str = "",
    for_pacs: bool = True,
    vdp: Optional[float] = None,
    patient_name: str = "",
    transfer_syntax: str = dcm.EXPLICIT_VR_LE,
) -> str:
    """Write the defect-overlay DICOM(s); returns the output path.

    transfer_syntax=dcm.RLE_LOSSLESS writes RLE Lossless compressed
    overlays (PS3.5 Annex G), lossless either way.
    """
    rgb = _defect_rgb(n4, defect)
    ds = ds.copy()
    desc_vdp = np.round(vdp, 1) if vdp is not None else ""
    ds.SeriesDescription = f"{optional_text} - VDP: {desc_vdp}"
    ds.SamplesPerPixel = 3
    ds.PhotometricInterpretation = "RGB"
    ds.PlanarConfiguration = 0
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.HighBit = 7
    ds.PixelRepresentation = 0
    if not for_pacs:
        frames = np.transpose(rgb, (2, 0, 1, 3))  # slices first for export
        ds.Rows, ds.Columns = rgb.shape[0], rgb.shape[1]
        ds.NumberOfFrames = rgb.shape[2]
        uid = dcm.generate_uid()
        ds.SOPInstanceUID = uid
        ds.SeriesInstanceUID = uid
        ds.add((0x7FE0, 0x0010), "OB", frames.tobytes())
        save_path = os.path.join(save_dir, f"{patient_name}_defectDICOM.dcm")
        ds.save_as(save_path, transfer_syntax=transfer_syntax)
        return save_path
    ds.SeriesInstanceUID = dcm.generate_uid()
    dicom_path = os.path.join(save_dir, "defectDICOMS")
    os.makedirs(dicom_path, exist_ok=True)
    ds.NumberOfFrames = 1
    for i in range(rgb.shape[2]):
        frame = rgb[:, :, i, :]
        ds.Rows, ds.Columns = frame.shape[0], frame.shape[1]
        ds.add((0x7FE0, 0x0010), "OB", frame.tobytes())
        ds.InstanceNumber = i + 1
        ds.SliceLocation = float(i)
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.save_as(os.path.join(dicom_path, f"dicom_{i}.dcm"),
                   transfer_syntax=transfer_syntax)
    return dicom_path


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


def load_npz(npz_path: str) -> Dict:
    """Load a save_npz artifact back into a state dict (the unPickleMe
    shape): arrays by name, scalars/dicts from the manifest, and the
    VentConfig reconstructed when its fields still match this version.

    Artifacts written by a newer version (higher artifact_version) raise a
    ValueError instead of silently dropping whatever the newer format
    added.  Corrupt or truncated files raise ValueError too (np.load's
    internals otherwise leak zipfile.BadZipFile, zlib.error and
    tokenize.TokenError on mutated bytes)."""
    import tokenize
    import zipfile
    import zlib

    with open(npz_path, "rb") as f:
        if f.read(2) != b"PK":
            # Not a zip container at all: np.load would fall through to its
            # pickle loader and emit a misleading "pickled data" error.
            raise ValueError(f"{npz_path} is not an NPZ file (no zip magic)")
    try:
        with np.load(npz_path, allow_pickle=False) as z:
            if _MANIFEST_KEY not in z.files:
                raise ValueError(
                    f"{npz_path} is not a ventjax study artifact "
                    f"(missing {_MANIFEST_KEY} manifest)")
            manifest = json.loads(str(z[_MANIFEST_KEY]))
            version = manifest.get("artifact_version")
            if not isinstance(version, int) or version > ARTIFACT_VERSION:
                raise ValueError(
                    f"{npz_path} has artifact_version {version!r}; this "
                    f"ventjax reads up to {ARTIFACT_VERSION}. Upgrade "
                    f"ventjax to load it.")
            state: Dict = {k: z[k] for k in z.files if k != _MANIFEST_KEY}
    except (zipfile.BadZipFile, zlib.error, tokenize.TokenError) as e:
        raise ValueError(
            f"{npz_path} is corrupt or not an NPZ file: {e}") from e
    state.update(manifest.get("scalars", {}))
    state.update(manifest.get("dicts", {}))
    cfg = manifest.get("config")
    if cfg is not None:
        from ventjax_torch.config import VentConfig

        # Field drift across versions: unknown keys are dropped (with a
        # warning) and missing ones take current defaults, so downstream
        # consumers always see a VentConfig, never a raw dict.
        known = {f.name for f in dataclasses.fields(VentConfig)}
        dropped = sorted(set(cfg) - known)
        if dropped:
            warnings.warn(
                f"{npz_path}: artifact config keys {dropped} are unknown to "
                f"this ventjax version; loading with current defaults",
                stacklevel=2)
        state["config"] = VentConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in cfg.items() if k in known})
    return state


def save_pickle(state: Dict, pickle_path: str) -> str:
    """Pickle every picklable entry of a study state dict
    (the reference's checkpoint format, Vent_Analysis.py:542-553)."""
    out = {}
    for key, value in state.items():
        try:
            pickle.dumps(value)
            out[key] = value
        except (pickle.PicklingError, AttributeError, TypeError):
            # the reference's exact skip set (Vent_Analysis.py:548-549);
            # anything else propagates there too
            continue
    with open(pickle_path, "wb") as f:
        pickle.dump(out, f)
    return pickle_path


# Modules the reference application's environment has but this one does
# not.  A pickle written by the reference class (which pickles
# self.__dict__ wholesale) embeds pydicom Dataset objects under its 'ds'
# key; loading that without detection would die inside pickle with an
# opaque ModuleNotFoundError.
_FOREIGN_MODULES = ("pydicom", "mapVbVd", "mapvbvd", "SimpleITK", "PyQt5",
                    "pyqtgraph", "nibabel")


class ReferencePickleError(RuntimeError):
    """A pickle written by the reference app embeds objects from modules
    unavailable here (pydicom etc.)."""


class ForeignStub:
    """Placeholder for an unpicklable foreign object (strip_foreign=True).

    Captures whatever state pickle hands it so nothing crashes; repr names
    the original class so users can see what was dropped."""

    _foreign_class = "?"

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["_foreign_state"] = state

    def append(self, *a, **k):  # pydicom pickles some list-like containers
        pass

    def extend(self, *a, **k):
        pass

    def __setitem__(self, *a, **k):  # dict-like containers (SETITEMS opcode)
        pass

    def update(self, *a, **k):
        pass

    def __repr__(self):
        return f"<ForeignStub of {self._foreign_class}>"


def _port_class(module: str, name: str):
    """The port's class of the same name for a class of the reference
    package (``ventjax.<m>.<name>`` -> ``ventjax_torch.<m>.<name>``), or
    None where the port has none."""
    try:
        mod = importlib.import_module("ventjax_torch" + module[len("ventjax"):])
    except ImportError:
        return None
    return getattr(mod, name, None)


class _DetectingUnpickler(pickle.Unpickler):
    def __init__(self, f, strip_foreign: bool):
        super().__init__(f)
        self._strip = strip_foreign
        self.foreign_classes: list = []

    def _foreign(self, module, name, why):
        qual = f"{module}.{name}"
        self.foreign_classes.append(qual)
        if not self._strip:
            raise ReferencePickleError(
                f"{qual} inside this pickle: {why} Options: (1) load with "
                "load_pickle(path, strip_foreign=True) to replace them "
                "with placeholders (all array/metric state is kept), or "
                "(2) in an environment with the writer's packages "
                "installed, re-save after deleting the 'ds' attribute."
            )
        return type(f"ForeignStub_{name}", (ForeignStub,),
                    {"_foreign_class": qual})

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _FOREIGN_MODULES:
            return self._foreign(module, name, (
                "it was written by the reference Vent_Analysis app, which "
                f"embeds raw {root} objects in its state (Vent_Analysis.py "
                "pickleMe)."))
        if root == "ventjax":
            # Written by the reference package: its classes have copies of
            # the same name here, and importing that package would load JAX.
            cls = _port_class(module, name)
            if cls is None:
                return self._foreign(module, name, (
                    "it was written by the ventjax package, and "
                    "ventjax_torch has no copy of that class."))
            return cls
        return super().find_class(module, name)


def load_pickle(pickle_path: str, strip_foreign: bool = False) -> Dict:
    """Load a study-state pickle (the port's, the reference package's or
    the reference app's).

    Reference-app pickles embed pydicom objects; by default loading one
    raises ReferencePickleError with the conversion options instead of an
    opaque ModuleNotFoundError.  strip_foreign=True substitutes ForeignStub
    placeholders and returns the rest of the state."""
    with open(pickle_path, "rb") as f:
        u = _DetectingUnpickler(f, strip_foreign)
        return u.load()


def study_filename(irb: str, metadata: Dict, **fields) -> str:
    """The GUI's export filename grammar (Vent_Analysis.py:961-984).

    irb in {'genxe', 'mepo', 'clinical'}; fields supply the study-specific
    ids/flags (genxe_id, treatment, mepo_id, visit, clinical_id, ...).
    """
    date = str(metadata.get("StudyDate", ""))[2:]
    irb = irb.lower()
    if irb == "genxe":
        name = f"Xe-{fields.get('genxe_id', '0000')}_{date}"
        t = fields.get("treatment", "")
        suffix = {"preAlbuterol": "_preAlb", "postAlbuterol": "_postAlb",
                  "preSildenafil": "_preSil", "postSildenafil": "_postSil"}
        name += suffix.get(t, "")
        return name
    if irb == "mepo":
        name = f"Mepo{fields.get('mepo_id', '0000')}_{date}"
        visit = fields.get("visit")
        if visit:
            name += f"_visit{visit}"
        t = fields.get("treatment", "")
        if t in ("preAlb", "postAlb"):
            name += f"_{t}"
        return name
    if irb == "clinical":
        name = (f"Clinical_{fields.get('clinical_id', '')}_{date}"
                f"_visit{fields.get('visit', 0)}")
        t = fields.get("treatment", "")
        if t == "Albuterol":
            name += "_Albuterol"
        elif t == "baseline":
            name += "_baseline"
        # neither radio selected -> no suffix (Vent_Analysis.py:982-984)
        return name
    raise ValueError(f"unknown IRB study type {irb!r}")
