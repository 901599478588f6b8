"""Headless GUI controller — the reference event loop as testable methods.

The counterpart of ``ventjax/gui/controller.py``: the same events, status
texts and colours, button states and filename grammar, over the port's
``Vent_Analysis``, which runs on the controller's ``device`` (the card
unless the caller asks for the CPU).

Each public method of :class:`VentController` is one event branch of the
reference's PySimpleGUI loop (the reference's Vent_Analysis.py:784-1013):
load-from-paths, load-pickle, calculate VDP, calculate CI, import TWIX,
patient-info edits, clear-cache, and export.  Status texts/colors, button
highlight states, IRB panel visibility, export validations, and the export
filename grammar reproduce the reference's behavior (citations inline);
the view (`ventjax_torch.gui.app`) only renders :class:`GuiState` and forwards
widget events here, so everything user-visible is exercised by
``tests/test_torch_gui.py`` without a display.

Deviations from the reference, all upgrades:
  * Import TWIX actually runs (the reference's button body is commented
    out, Vent_Analysis.py:900-915, though ``process_RAW`` is live API).
  * The archive path is a field, not a hard-coded UNC share
    (Vent_Analysis.py:610).
  * Errors carry the exception text after the reference's status message
    instead of a bare ``except: continue``.
"""
from __future__ import annotations

import dataclasses
import os
import traceback
from datetime import date
from typing import Dict, Optional

import numpy as np

from ventjax_torch.report.export import study_filename

# Button highlight states (the reference recolors buttons lightgray/green,
# e.g. Vent_Analysis.py:851-854, 878, 892).
IDLE = "lightgray"
DONE = "green"

_BUTTONS = ("initialize", "calcvdp", "calcci", "runtwix", "export")


@dataclasses.dataclass
class Status:
    """The GUI status line (`-STATUS-`): text + color."""

    text: str = ""
    color: str = "black"


@dataclasses.dataclass
class GuiState:
    """Every user-editable field of the reference window, pythonic names.

    Defaults mirror the reference's empty launch state (its C:/PIRL demo
    default paths are intentionally not reproduced).
    """

    # Path inputs (Vent_Analysis.py:651-655)
    dicom_path: str = ""
    mask_path: str = ""
    proton_path: str = ""
    twix_path: str = ""
    export_path: str = ""
    # Top bar (line 703)
    user: str = ""
    notes: str = ""
    # IRB study select (lines 656-672): None | 'genxe' | 'mepo' | 'clinical'
    irb: Optional[str] = None
    genxe_id: str = "0000"
    disease: str = ""
    genxe_treatment: str = ""      # '', preAlbuterol, postAlbuterol,
    #                                 preSildenafil, postSildenafil
    mepo_id: str = "0000"
    mepo_subject: str = "0"
    mepo_visit: str = ""           # '', '1', '2', '3'
    mepo_treatment: str = ""       # '', preAlb, postAlb
    clinical_id: str = ""
    clinical_visit: str = "0"
    clinical_treatment: str = ""   # '', baseline, Albuterol
    # Dose / PFT inputs (lines 673-676)
    de: str = ""
    fev1: str = ""
    fvc: str = ""
    # Export row (lines 717-718)
    archive: bool = True
    archive_path: str = ""
    # Image pane height; +/- buttons step by 5 (lines 609, 793-799)
    image_box_size: int = 50


class VentController:
    """The reference GUI's event handlers over :class:`GuiState`.

    ``study`` is the single mutable Vent_Analysis instance the reference
    keeps as the global ``Vent1`` (Vent_Analysis.py:846-864).
    """

    def __init__(self, state: Optional[GuiState] = None, config=None,
                 device="cuda"):
        self.state = state or GuiState()
        self.config = config  # None -> the compat facade's DEFAULT_CONFIG
        self.device = device  # where Vent_Analysis runs
        self.study = None
        self.status = Status()
        self.buttons: Dict[str, str] = {b: IDLE for b in _BUTTONS}
        # Optional observer called on every status change; the tkinter view
        # uses it to paint in-progress ("blue") statuses before a long
        # synchronous action returns (the reference repaints its window the
        # same way between event and computation).
        self.on_status = None

    # ---- helpers -----------------------------------------------------------
    def _set_status(self, text: str, color: str) -> None:
        self.status = Status(text, color)
        if self.on_status is not None:
            self.on_status(self.status)

    def _fail(self, text: str, exc: Optional[BaseException] = None) -> bool:
        detail = f" [{exc}]" if exc is not None else ""
        self._set_status(text + detail, "red")
        return False

    @property
    def irb_panel_visible(self) -> Dict[str, bool]:
        """Which per-study input column shows (Vent_Analysis.py:802-816)."""
        return {k: self.state.irb == k for k in ("genxe", "mepo", "clinical")}

    def select_irb(self, irb: Optional[str]) -> None:
        if irb is not None and irb not in ("genxe", "mepo", "clinical"):
            raise ValueError(f"unknown IRB study type {irb!r}")
        self.state.irb = irb

    # ---- '-INITIALIZE-' (Vent_Analysis.py:846-871) -------------------------
    def load_from_paths(self) -> bool:
        from ventjax_torch.compat import Vent_Analysis

        for b in _BUTTONS:
            if b != "initialize":
                self.buttons[b] = IDLE
        self.study = None  # the reference `del Vent1`s first (line 856)
        try:
            s = self.state
            kw = {"device": self.device}
            if self.config is not None:
                kw["config"] = self.config
            self.study = Vent_Analysis(
                xenon_path=s.dicom_path, mask_path=s.mask_path,
                proton_path=s.proton_path or None, **kw,
            )
        except Exception as e:
            self.buttons["initialize"] = IDLE
            return self._fail(
                "ERROR: Uhh you messed something up. Maybe check your "
                "DICOM and MASK paths?", e)
        self._set_status("Vent_Analysis loaded", "green")
        self.buttons["initialize"] = DONE
        return True

    # ---- '-LOADPICKLE-' (Vent_Analysis.py:838-844) -------------------------
    def load_pickle(self, pickle_path: str) -> bool:
        from ventjax_torch.compat import Vent_Analysis

        try:
            kw = {"device": self.device}
            if self.config is not None:
                kw["config"] = self.config
            self.study = Vent_Analysis(pickle_path=pickle_path, **kw)
        except Exception as e:
            return self._fail("ERROR: could not load pickle", e)
        self._set_status("Vent_Analysis pickle loaded", "green")
        self.buttons["initialize"] = DONE
        return True

    # ---- '-CALCVDP-' (Vent_Analysis.py:874-884) ----------------------------
    def calculate_vdp(self, thresh: float = 0.6) -> bool:
        self._set_status("Calculating VDP...", "blue")
        try:
            self.study.calculate_VDP(thresh=thresh)
        except Exception as e:
            return self._fail(
                "ERROR: VDP either couldnt run or be displayed for some "
                "reason...", e)
        self._set_status("VDP Calculated", "green")
        self.buttons["calcvdp"] = DONE
        return True

    # ---- '-CALCCI-' (Vent_Analysis.py:887-897) -----------------------------
    def calculate_ci(self) -> bool:
        self._set_status("Calculating CI...", "blue")
        try:
            self.study.calculate_CI()
        except Exception as e:
            return self._fail("ERROR: CI couldnt run for some reason...", e)
        self._set_status("CI Calculated successfully", "green")
        self.buttons["calcci"] = DONE
        return True

    # ---- '-RUNTWIX-' (Vent_Analysis.py:900-915; live here) -----------------
    def import_twix(self) -> bool:
        self._set_status("Processing TWIX file...", "blue")
        try:
            self.study.process_RAW(self.state.twix_path)
        except Exception as e:
            return self._fail(
                "ERROR: TWIX couldnt process for some reason...", e)
        self._set_status("TWIX Processed successfully", "green")
        self.buttons["runtwix"] = DONE
        return True

    # ---- Info edit popups (Vent_Analysis.py:819-836, 988-994) --------------
    def edit_metadata(self, key: str, value) -> None:
        self.study.metadata[key] = value

    # ---- '-CLEARCACHE-' (Vent_Analysis.py:918-938) -------------------------
    def clear_cache(self) -> None:
        self.study = None
        self.state.notes = ""
        self.state.irb = None
        for b in _BUTTONS:
            self.buttons[b] = IDLE
        self._set_status(
            "Analysis Cache is cleared and ready for the next subject!...",
            "blue")

    # ---- '-EXPORT-' (Vent_Analysis.py:943-1013) ----------------------------
    def export_filename(self) -> str:
        """The per-study export filename grammar (lines 961-984)."""
        s = self.state
        treatment = {
            "genxe": s.genxe_treatment,
            "mepo": s.mepo_treatment,
            "clinical": s.clinical_treatment,
        }[s.irb]
        visit = {"genxe": None, "mepo": s.mepo_visit or None,
                 "clinical": s.clinical_visit}[s.irb]
        return study_filename(
            s.irb, self.study.metadata,
            genxe_id=s.genxe_id, mepo_id=s.mepo_id, clinical_id=s.clinical_id,
            visit=visit, treatment=treatment,
        )

    def export(self, today: Optional[str] = None) -> bool:
        s = self.state
        # Validations, same order + texts as the reference (lines 950-958).
        if s.user == "":
            return self._fail("Don't forget to enter your Name or Initials "
                              "at the very top right!...")
        if s.irb is None:
            return self._fail("Don't forget to select an IRB!...")
        self._set_status("Exporting Data...", "blue")
        today = today or date.today().strftime("%y%m%d")
        export_dir = os.path.join(
            s.export_path, f"VentAnalysis_{s.user}_{today}")
        try:
            file_name = self.export_filename()
            md = self.study.metadata
            md["fileName"] = file_name
            md["DE"], md["FEV1"], md["FVC"] = s.de, s.fev1, s.fvc
            md["IRB"] = s.irb
            md["notes"] = s.notes
            md["analysisUser"] = s.user
            md["Disease"] = s.disease or md.get("Disease", "")
            if s.irb == "genxe" and s.genxe_treatment:
                md["treatment"] = s.genxe_treatment
            elif s.irb == "mepo":
                if s.mepo_visit:
                    md["visit"] = int(s.mepo_visit)
                if s.mepo_treatment:
                    md["treatment"] = s.mepo_treatment
            elif s.irb == "clinical":
                md["treatment"] = ("Albuterol"
                                   if s.clinical_treatment == "Albuterol"
                                   else "none")
            os.makedirs(export_dir, exist_ok=True)
            v = self.study
            v.exportNifti(export_dir, file_name)
            v.dicom_to_json(
                v.ds, json_path=os.path.join(export_dir, f"{file_name}.json"))
            v.pickleMe(
                pickle_path=os.path.join(export_dir, f"{file_name}.pkl"))
            v.screenShot(path=os.path.join(export_dir, f"{file_name}.png"))
            v.exportDICOM(v.ds, export_dir, optional_text=file_name,
                          forPACS=True)
        except Exception as e:
            traceback.print_exc()
            return self._fail("ERROR: export failed", e)
        self._set_status("Data Successfully Exported...", "green")
        self.buttons["export"] = DONE
        # Archive copy (lines 1006-1013): green if archived, orange if the
        # archive path does not exist.
        if s.archive:
            if s.archive_path and os.path.isdir(s.archive_path):
                self.study.pickleMe(pickle_path=os.path.join(
                    s.archive_path, f"{file_name}.pkl"))
                self._set_status(
                    "Data Successfully Exported and Archived...", "green")
            else:
                self._set_status(
                    "Data Successfully Exported but not Archived...",
                    "orange")
        return True

    # ---- view feeds --------------------------------------------------------
    def pane_images(self) -> Dict[str, np.ndarray]:
        """Six image panes as RGB arrays (updateImages,
        Vent_Analysis.py:720-759); black 3x3 placeholders when unloaded."""
        if self.study is None:
            blank = np.zeros((3, 3, 3))
            return {k: blank for k in
                    ("twix", "proton", "raw", "n4", "defect", "ci")}
        panes = self.study.pane_images()
        raw = self.study.raw_HPvent
        if not isinstance(raw, str):  # import_twix ran
            from ventjax_torch.oracle.reference import normalize
            from ventjax_torch.report.montage import montage_row

            m = normalize(np.abs(montage_row(np.asarray(raw))))
            panes["twix"] = np.stack([m, m, m], axis=-1) * 255
        return panes

    def data_summary(self) -> Dict[str, str]:
        """The patient/DICOM data labels (updateData,
        Vent_Analysis.py:762-783), keyed like the reference's widgets."""
        if self.study is None:
            return {}
        v = self.study
        md = v.metadata
        out = {
            "subject": f"Subject: {md['PatientName']}",
            "studydate": f"Study Date: {md['StudyDate']}",
            "studytime": f"Study Time: {md.get('StudyTime', '')}",
            "age": f"Age: {md['PatientAge']}",
            "sex": f"Sex: {md['PatientSex']}",
            "dob": f"DOB: {md['PatientBirthDate']}",
            "vox": f"DICOM voxel Size: {v.vox} [mm]",
            "snr": f"SNR: {md['SNR']}",
            "vdp": f"VDP: {md['VDP']}",
            "masklungvol": f"Mask Lung Volume: {md['LungVolume']} [L]",
            "defectvolume": f"Defect Volume: {md['DefectVolume']} [L]",
            "ci": f"CI: {md['CI']}",
            "twixdate":
                f"Twix Date: {md.get('TWIXscanDateTime', '')}",
            "twixprotocol":
                f"Twix Protocol: {md.get('TWIXprotocolName', '')}",
        }
        try:
            out["ventarrayshape"] = (
                f"Ventilation Array Shape: {v.HPvent.shape}")
        except AttributeError:
            out["ventarrayshape"] = "Ventilation Array Shape:"
        return out
