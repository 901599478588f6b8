"""Vent_Analysis compatibility facade, on the card.

Counterpart of ``ventjax/compat/vent_analysis.py``: the reference class
(Vent_Analysis.py:26-600) with the same constructor signature, attribute
names, method names and metadata keys, plus one keyword, ``device``: the
CUDA card unless ``device="cpu"`` is given (without a card the constructor
raises; nothing falls back to the CPU).  Each method moves its arrays to
the device, runs the port's ops there (N4 launches kernels K4, K5, K1 and
K2; the CI map K3) and keeps its results as NumPy attributes with the
reference package's dtypes, so a study's state pickles and saves exactly
as that package's does.  The device is kept in a slot, out of
``vars(self)``: pickles and NPZ artifacts hold no torch object.

Behavioural deviations from the reference application, as in the
reference package:
- interactive file-dialog fallbacks are replaced with errors when paths
  are missing, and stdin prompts only on a TTY;
- CI saturation clamps at Rmax (the reference raises ValueError);
- exports default to the current directory, not C:/PIRL/data;
- calculate_SNR(manualNoise=True) raises NotImplementedError: the
  reference's True branch is dead code (its subarray picker is commented
  out, leaving `noise` unbound).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ventjax_torch.config import DEFAULT_CONFIG, REFERENCE_VERSION, VentConfig
from ventjax_torch.io import dicom as dcm
from ventjax_torch.ops.basic import gradient_border, sort_compact_masked
from ventjax_torch.ops.kmeans import vdp_kmeans
from ventjax_torch.ops.n4 import n4_bias_correction
from ventjax_torch.ops.snr import calculate_snr as _snr_op
from ventjax_torch.ops.vdp import vdp_linear_binning, vdp_mean_anchored
from ventjax_torch.oracle.reference import crop_to_data, normalize
from ventjax_torch.report import export as rexport
from ventjax_torch.utils.device import resolve_device

_METADATA_KEYS = [
    "fileName", "PatientName", "PatientAge", "PatientBirthDate", "PatientSex",
    "Disease", "StudyDate", "SeriesTime", "DE", "SNR", "VDP", "VDP_lb",
    "VDP_km", "LungVolume", "DefectVolume", "CI", "FEV1", "FVC", "visit",
    "IRB", "treatment", "analysisUser", "notes",
]


class Vent_Analysis:
    """Reference-compatible ventilation analysis on a torch device.

    Mirrors the constructor dispatch of Vent_Analysis.py:58-166: arrays,
    DICOM paths, or a pickle (dict or path), or an NPZ artifact.
    """

    # ``device`` lives in a slot, so vars(self) — what pickleMe and saveNpz
    # write — holds the reference package's state keys and nothing else.
    __slots__ = ("device", "__dict__")

    def __init__(self, xenon_path=None, mask_path=None, proton_path=None,
                 xenon_array=None, mask_array=None, proton_array=None,
                 pickle_dict=None, pickle_path=None, npz_path=None,
                 config: VentConfig = DEFAULT_CONFIG, device="cuda"):
        self.device = resolve_device(device)
        self.version = REFERENCE_VERSION
        self.config = config
        self.proton = ""
        self.N4HPvent = ""
        self.defectArray = ""
        self.CIarray = ""
        self.vox = ""
        self.ds = ""
        self.twix = ""
        self.raw_k = ""
        self.raw_HPvent = ""
        self.metadata = {k: "" for k in _METADATA_KEYS}

        if xenon_array is not None:
            self.HPvent = xenon_array
        if xenon_path is not None:
            self.ds, self.HPvent = self.openSingleDICOM(xenon_path)
            self.pullDICOMHeader()
        if mask_array is not None:
            self.mask = mask_array
            self.mask_border = self.calculateBorder(self.mask)
        if mask_path is not None:
            _, self.mask = self.openDICOMfolder(mask_path)
            self.mask_border = self.calculateBorder(self.mask)
        if proton_array is not None:
            self.proton = proton_array
        if proton_path is not None:
            self.proton_ds, self.proton = self.openSingleDICOM(proton_path)
        if sum(x is not None for x in (pickle_dict, pickle_path,
                                       npz_path)) > 1:
            raise ValueError(
                "pass at most one of pickle_dict / pickle_path / npz_path "
                "— resuming from several sources at once is ambiguous")
        if pickle_path is not None:
            # load_pickle detects reference-app pickles (embedded pydicom
            # objects) and raises an actionable error, and reads the
            # reference package's classes as the port's copies.
            pickle_dict = rexport.load_pickle(pickle_path)
        if npz_path is not None:
            # versioned NPZ artifact (saveNpz) — the pickle-free resume path
            pickle_dict = rexport.load_npz(npz_path)
        if pickle_dict is not None:
            self.unPickleMe(pickle_dict)
        if hasattr(self, "mask") and not isinstance(self.vox, str):
            self.metadata["LungVolume"] = (
                np.sum(self.mask == 1) * np.prod(np.divide(self.vox, 10)) / 1000
            )

    def _on_device(self, a) -> torch.Tensor:
        """A host array as a float32 [1, H, W, D] tensor on the device."""
        return torch.from_numpy(
            np.ascontiguousarray(a, np.float32))[None].to(self.device)

    # ---- L1 I/O (Vent_Analysis.py:169-223) --------------------------------
    def openSingleDICOM(self, dicom_path):
        if dicom_path is None:
            raise ValueError("dicom_path is required (no GUI file dialog)")
        return dcm.open_single_dicom(dicom_path)

    def openDICOMfolder(self, maskFolder):
        if maskFolder is None:
            raise ValueError("mask folder is required (no GUI file dialog)")
        return dcm.open_dicom_folder(maskFolder)

    def pullDICOMHeader(self):
        """Header elements -> metadata; voxel-size discovery over per-frame
        functional groups (Vent_Analysis.py:198-223)."""
        for elem in ["PatientName", "PatientAge", "PatientBirthDate",
                     "PatientSize", "PatientWeight", "PatientSex",
                     "StudyDate", "StudyTime", "SeriesTime"]:
            self.metadata[elem] = self.ds.get(elem, "")
        # The reference's "get more header info into metadata" roadmap
        # item: acquisition/scanner context, added only when the header
        # carries it (the 23 core keys above keep their ''-on-missing
        # reference behaviour).
        for elem in ["Modality", "SeriesDescription", "Manufacturer",
                     "ManufacturerModelName", "ProtocolName",
                     "RepetitionTime", "EchoTime", "FlipAngle",
                     "MagneticFieldStrength", "SliceThickness",
                     "StudyInstanceUID", "SeriesInstanceUID"]:
            if elem in self.ds:
                self.metadata[elem] = self.ds.get(elem)

        self.vox = None
        for k in range(100):
            try:
                self.vox = list(
                    self.ds[(0x5200, 0x9230)][k]["PixelMeasuresSequence"][0]
                    .PixelSpacing
                )
                break
            except Exception:
                continue
        if self.vox is None:
            ps = self.ds.get("PixelSpacing")
            if ps is not None:
                self.vox = list(ps)
            elif sys.stdin.isatty():
                print("Pixel Spacing not found; enter row and col spacing:")
                self.vox = [float(input()), float(input())]
            else:
                raise ValueError("PixelSpacing not found in DICOM header")
        try:
            self.vox = [float(self.vox[0]), float(self.vox[1]),
                        float(self.ds.SpacingBetweenSlices)]
        except Exception:
            if sys.stdin.isatty():
                print("Slice spacing not found; enter it:")
                self.vox = [float(self.vox[0]), float(self.vox[1]),
                            float(input())]
            else:
                raise ValueError("SpacingBetweenSlices not found")
        if hasattr(self, "mask"):
            self.metadata["LungVolume"] = (
                np.sum(self.mask == 1) * np.prod(np.divide(self.vox, 10)) / 1000
            )

    def exportHistogram(self, path="signalHistogram.png"):
        """Masked-signal histogram with the linear-binning edges (the
        reference's "show histogram?" roadmap item).  Uses the
        N4-corrected signal once calculate_VDP has run, the raw signal
        otherwise.  Needs Pillow."""
        from ventjax_torch.report.histogram import signal_histogram

        sig = self.N4HPvent if not isinstance(self.N4HPvent, str) \
            else self.HPvent
        vdp_lb = self.metadata.get("VDP_lb")
        return signal_histogram(
            path, np.asarray(sig, np.float64), np.asarray(self.mask),
            edges=self.config.lb_edges, percentile=self.config.lb_percentile,
            title=f"{self.metadata.get('PatientName', '')} masked signal",
            vdp_lb=vdp_lb if vdp_lb != "" else None,
        )

    def editMask(self, ops: str, slicewise: bool = True):
        """Apply a morphology recipe to the mask on the device (the
        reference's "edit mask" roadmap item), e.g.
        "close:1,fillholes,erode:1".

        Recomputes the mask border and LungVolume, and invalidates any
        previously computed analysis (rerun calculate_VDP / calculate_CI —
        same as loading a new mask would)."""
        from ventjax_torch.ops.morphology import edit_mask

        self.mask = edit_mask(self._on_device(self.mask)[0], ops,
                              slicewise=slicewise).cpu().numpy().astype(
                                  np.float64)
        self.mask_border = self.calculateBorder(self.mask)
        # vox is the '' string sentinel until a header (or caller) sets it
        if getattr(self, "vox", None) is not None \
                and not isinstance(self.vox, str):
            self.metadata["LungVolume"] = (
                np.sum(self.mask == 1)
                * np.prod(np.divide(self.vox, 10)) / 1000
            )
        return self.mask

    # ---- L2 utilities (Vent_Analysis.py:225-237, 430-456) ------------------
    def calculateBorder(self, A):
        return gradient_border(self._on_device(A))[0].cpu().numpy()

    def normalize(self, x):
        rng = np.max(x) - np.min(x)
        return x if rng == 0 else (x - np.min(x)) / rng

    def cropToData(self, A, border=0, borderSlices=False):
        return crop_to_data(A, border=border, border_slices=borderSlices)

    # ---- L3 analysis (Vent_Analysis.py:239-357; CI.py) ---------------------
    def _n4(self, hp, mask, mask_pad=None):
        c = self.config
        # full float32 products on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        return n4_bias_correction(
            hp, mask,
            fitting_levels=c.n4_fitting_levels, max_iters=c.n4_max_iters,
            convergence_threshold=c.n4_convergence_threshold,
            bins=c.n4_histogram_bins, fwhm=c.n4_bias_fwhm,
            wiener_noise=c.n4_wiener_noise, control_points=c.n4_control_points,
            mask_pad=mask_pad,
        )

    def calculate_VDP(self, thresh=0.6):
        """SNR -> N4 -> mean-anchored + linear-binning (+ k-means) VDP
        (Vent_Analysis.py:239-263, k-means stub made real), on the device.

        N4's masked-voxel pad is ``config.n4_mask_pad``; k-means runs on
        the dense N4 image compacted over the whole mask, as the
        reference package's facade runs it."""
        hp = self._on_device(self.HPvent)
        mask = self._on_device(self.mask)
        c = self.config
        self.metadata["SNR"] = float(_snr_op(hp, mask, c.snr_fov_buffer)[0])
        n4 = self._n4(hp, mask, mask_pad=c.n4_mask_pad)
        self.N4HPvent = n4[0].cpu().numpy()
        defect, vdp = vdp_mean_anchored(n4, mask, thresh)
        self.defectArray = defect[0].cpu().numpy().astype(np.float64)
        self.defectBorder = gradient_border(defect)[0].cpu().numpy() == 1
        self.metadata["VDP"] = float(vdp[0])
        self.metadata["DefectVolume"] = float(
            np.sum(self.defectArray == 1) * np.prod(np.divide(self.vox, 10)) / 1000
        )
        lb, vdp_lb = vdp_linear_binning(n4, mask, c.lb_edges, c.lb_percentile)
        self.defectArrayLB = lb[0].cpu().numpy().astype(np.float64)
        self.metadata["VDP_lb"] = float(vdp_lb[0])
        V = n4[0].numel()
        _, vals, n_m = sort_compact_masked(n4.reshape(1, -1),
                                           mask.reshape(1, -1) > 0, V)
        wv = (torch.arange(V, device=self.device)[None] < n_m[:, None]).to(
            torch.float32)
        km, vdp_km = vdp_kmeans(n4, mask, c.kmeans_clusters, c.kmeans_iters,
                                c.kmeans_defect_clusters, compacted=(vals, wv))
        self.defectArrayKM = km[0].cpu().numpy().astype(np.float64)
        self.metadata["VDP_km"] = float(vdp_km[0])

    def calculate_CI(self):
        """CI map + subject CI = 95th-pct CV (Vent_Analysis.py:265-271)."""
        from ventjax_torch.compat import ci_module

        self.CIarray = ci_module.calculate_CI(
            self.defectArray, vox=self.vox, Rmax=self.config.ci_rmax,
            config=self.config, device=self.device,
        )
        cvlist = np.sort(self.CIarray[self.defectArray > 0])
        # No defect voxels: NaN, matching the batched pipeline; the
        # reference raises IndexError there.
        self.metadata["CI"] = (cvlist[int(0.95 * len(cvlist))]
                               if len(cvlist) else float("nan"))
        return self.CIarray

    def N4_bias_correction(self, HPvent, mask):
        """Standalone N4 (Vent_Analysis.py:316-334): its pad is the whole
        volume."""
        return self._n4(self._on_device(HPvent),
                        self._on_device(mask))[0].cpu().numpy()

    def calculate_SNR(self, A, FOVbuffer=20, manualNoise=False):
        """SNR (Vent_Analysis.py:337-357).  NOTE: like the reference, the
        second positional arg is FOVbuffer (the reference passes the mask
        there by accident and overwrites it); the mask is self.mask."""
        if manualNoise:
            # Documented deviation (module docstring): the reference's
            # manualNoise=True branch is dead (its interactive subarray
            # picker is commented out, so `noise` is unbound and the call
            # would NameError).  Raise instead of silently returning
            # auto-noise SNR.
            raise NotImplementedError(
                "manualNoise=True: the reference implementation's manual-"
                "noise picker is commented-out dead code (Vent_Analysis.py"
                ":352-355 would NameError); use the default automatic "
                "noise region, or compute SNR from your own noise sample "
                "directly: (signal.mean()-noise.mean())/noise.std()")
        fov = 20  # line 343 overwrites whatever was passed
        return float(_snr_op(self._on_device(A), self._on_device(self.mask),
                             fov)[0])

    # ---- L4 export (Vent_Analysis.py:273-313, 360-428, 458-559) ------------
    def build4DdataArray(self):
        return rexport.build_4d_array(
            np.asarray(self.HPvent), np.asarray(self.mask),
            proton=None if isinstance(self.proton, str) else np.asarray(self.proton),
            n4=None if isinstance(self.N4HPvent, str) else self.N4HPvent,
            defect=None if isinstance(self.defectArray, str) else self.defectArray,
            ci=None if isinstance(self.CIarray, str) else self.CIarray,
        )

    def exportNifti(self, filepath=None, fileName=None):
        if filepath is None:
            filepath = os.getcwd()
        if fileName is None:
            fileName = str(self.metadata["PatientName"]).replace("^", "_")
        from ventjax_torch.io import nifti

        savepath = os.path.join(filepath, fileName + "_dataArray.nii")
        nifti.save(savepath, self.build4DdataArray(), affine=np.eye(4))
        return savepath

    def dicom_to_dict(self, elem, include_private=False):
        return dcm.dicom_to_dict(elem, include_private)

    def dicom_to_json(self, ds, json_path="DICOMjson.json", include_private=True):
        return rexport.dicom_to_json(ds, json_path, include_private)

    def exportDICOM(self, ds=None, save_dir=".", optional_text="", forPACS=True,
                    compress=False):
        if self.metadata["VDP"] == "":
            raise RuntimeError("run calculate_VDP() before exporting DICOMs")
        return rexport.export_dicom(
            ds if ds is not None else self.ds,
            self.N4HPvent, self.defectArray, save_dir,
            optional_text=optional_text, for_pacs=forPACS,
            vdp=self.metadata["VDP"],
            patient_name=str(self.metadata["PatientName"]),
            transfer_syntax=(dcm.RLE_LOSSLESS if compress
                             else dcm.EXPLICIT_VR_LE),
        )

    def screenShot(self, path="screenShotTest.png", normalize95=False):
        """The annotated 7-row montage PNG.  Needs Pillow."""
        from ventjax_torch.report.screenshot import screenshot

        return screenshot(
            path,
            hp=np.asarray(self.HPvent, np.float64),
            mask=np.asarray(self.mask, np.float64),
            mask_border=np.asarray(self.mask_border, np.float64),
            n4=np.asarray(self.N4HPvent, np.float64),
            defect=np.asarray(self.defectArray, np.float64),
            ci_map=None if isinstance(self.CIarray, str) else np.asarray(self.CIarray),
            proton=None if isinstance(self.proton, str) else np.asarray(self.proton, np.float64),
            metadata=self.metadata,
            version=self.version,
            crop_border=self.config.screenshot_crop_border,
            parula_num=self.config.parula_scale_num,
            parula_den=self.config.parula_scale_den,
        )

    def process_RAW(self, filepath=None):
        """TWIX ingest + FFT recon on the device (Vent_Analysis.py:522-540)."""
        from ventjax_torch.io import twix as twix_io
        from ventjax_torch.ops.fft_recon import recon_2d_multislice

        self.raw_twix = twix_io.read_twix(filepath)
        self.metadata["TWIXscanDateTime"] = self.raw_twix.scan_datetime
        self.metadata["TWIXprotocolName"] = self.raw_twix.protocol_name
        # The reference roadmap's "get more header info (both TWIX and
        # DICOM) into metadata": acquisition parameters mined from the
        # measurement header, TWIX-prefixed to keep them distinct from the
        # DICOM keys of the same name.
        for key, val in self.raw_twix.header_params.items():
            self.metadata[f"TWIX{key}"] = val
        self.raw_K = self.raw_twix.kspace()
        self.raw_HPvent = recon_2d_multislice(self.raw_K, device=self.device)
        return self.raw_HPvent

    def pickleMe(self, pickle_path="VentPickle.pkl"):
        return rexport.save_pickle(vars(self), pickle_path)

    def unPickleMe(self, pickle_dict):
        for attr, value in pickle_dict.items():
            setattr(self, attr, value)

    def saveNpz(self, npz_path="VentArtifact.npz"):
        """Versioned pickle-free study artifact (report.export.save_npz):
        every array attribute + metadata + config in one np.savez file that
        loads anywhere NumPy exists.  Resume with Vent_Analysis(npz_path=...)."""
        return rexport.save_npz(vars(self), npz_path)

    # ---- GUI-pane montage helpers (Vent_Analysis.py:644-645, 628-634,
    # 722-759 updateImages) — the desktop panes as plain RGB arrays --------
    @staticmethod
    def array3D_to_montage2D(A):
        """abs() slices in one row (Vent_Analysis.py:644-645)."""
        from ventjax_torch.report.montage import montage_row

        return montage_row(np.asarray(A))

    @staticmethod
    def colorBinary(A, B):
        """Gray montage with a binary overlay painted red, 0-255 RGB
        (Vent_Analysis.py:628-634)."""
        from ventjax_torch.report.montage import color_binary

        return color_binary(np.asarray(A), np.asarray(B))

    def pane_images(self):
        """The GUI's six image panes (updateImages, Vent_Analysis.py:722-759)
        as a dict of RGB float arrays; panes whose inputs are missing map to
        the GUI's 3x3 black placeholder, exactly like its try/excepts."""
        blank = np.zeros((3, 3, 3))
        panes = {"twix": blank}

        def gray(m):
            return np.stack([normalize(m)] * 3, axis=-1) * 255

        try:
            panes["proton"] = gray(self.array3D_to_montage2D(self.proton))
        except Exception:
            panes["proton"] = blank
        try:
            border = self.array3D_to_montage2D(self.mask_border)
            raw = self.array3D_to_montage2D(self.HPvent)
            panes["raw"] = self.colorBinary(raw, border)
        except Exception:
            panes["raw"] = blank
        try:
            n4m = self.array3D_to_montage2D(self.N4HPvent)
            border = self.array3D_to_montage2D(self.mask_border)
            panes["n4"] = self.colorBinary(n4m, border)
        except Exception:
            panes["n4"] = blank
        try:
            defect = self.array3D_to_montage2D(self.defectArray)
            panes["defect"] = self.colorBinary(n4m, defect)
        except Exception:
            panes["defect"] = blank
        try:
            ci = self.array3D_to_montage2D(self.CIarray)
            panes["ci"] = self.colorBinary(n4m, ci)
        except Exception:
            panes["ci"] = blank
        return panes

    def __repr__(self):
        string = (f"Vent_Analysis (ventjax_torch) version {self.version}\n")
        for attr, value in vars(self).items():
            if isinstance(value, np.ndarray):
                string += f"  {attr}: array{value.shape}\n"
            elif isinstance(value, dict):
                for k, v in value.items():
                    string += f"    {k}: {v}\n"
            else:
                string += f"  {attr}: {type(value).__name__}\n"
        return string


def extract_attributes(attr_dict, parent_key="", sep="_"):
    """Flatten nested dicts with sep-joined keys (Vent_Analysis.py:579-600)."""
    items = []
    for k, v in attr_dict.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else k
        if isinstance(v, dict):
            items.extend(extract_attributes(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)
