"""Synthetic DICOM studies on disk — test fixtures for the full I/O path.

Builds the exact on-disk layout the reference consumes
(SURVEY.md §4 item 4): one multi-frame xenon DICOM with
PerFrameFunctionalGroupsSequence voxel metadata, a folder of per-slice mask
DICOMs, and an optional proton DICOM.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ventjax_torch.io import dicom as dcm
from ventjax_torch.io.phantom import Phantom, make_phantom


def _base_dataset(name: str, study_date: str = "20240301") -> dcm.Dataset:
    ds = dcm.Dataset()
    ds.SOPClassUID = dcm.ENHANCED_MR_STORAGE
    ds.SOPInstanceUID = dcm.generate_uid()
    ds.StudyInstanceUID = dcm.generate_uid()
    ds.SeriesInstanceUID = dcm.generate_uid()
    ds.Modality = "MR"
    ds.PatientName = name
    ds.PatientID = "VJ0001"
    ds.PatientAge = "042Y"
    ds.PatientBirthDate = "19820301"
    ds.PatientSex = "F"
    ds.PatientSize = 1.7
    ds.PatientWeight = 65.0
    ds.StudyDate = study_date
    ds.StudyTime = "101500"
    ds.SeriesTime = "102000"
    # Acquisition/scanner context — the reference roadmap's "more header
    # info into metadata" (README.md:25); pullDICOMHeader picks these up
    # when present.
    ds.Manufacturer = "SIEMENS"
    ds.ManufacturerModelName = "Prisma"
    ds.ProtocolName = "fl_gre_vent"
    ds.SeriesDescription = "129Xe ventilation"
    ds.RepetitionTime = 15.0
    ds.EchoTime = 0.675
    ds.FlipAngle = 10.0
    ds.MagneticFieldStrength = 2.89362
    return ds


def write_multiframe(
    path: str,
    volume: np.ndarray,          # [H, W, D]
    vox: Tuple[float, float, float],
    name: str = "VENTJAX^PHANTOM",
) -> None:
    """Multi-frame DICOM with per-frame PixelMeasures (what pullDICOMHeader
    discovers at Vent_Analysis.py:208-218)."""
    H, W, D = volume.shape
    ds = _base_dataset(name)
    ds.Rows = H
    ds.Columns = W
    ds.NumberOfFrames = D
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SpacingBetweenSlices = float(vox[2])
    frames = []
    for _ in range(D):
        pm = dcm.Dataset()
        pm.PixelSpacing = dcm.MultiValue([float(vox[0]), float(vox[1])])
        pm.SliceThickness = float(vox[2])
        frame = dcm.Dataset()
        frame.add((0x0028, 0x9110), "SQ", [pm])
        frames.append(frame)
    ds.add((0x5200, 0x9230), "SQ", frames)
    # frames-major pixel data: [D, H, W] uint16
    vol16 = np.clip(np.transpose(volume, (2, 0, 1)), 0, 65535).astype("<u2")
    ds.add((0x7FE0, 0x0010), "OW", vol16.tobytes())
    ds.save_as(path)


def write_mask_folder(
    folder: str,
    mask: np.ndarray,            # [H, W, D]
    vox: Tuple[float, float, float],
) -> None:
    os.makedirs(folder, exist_ok=True)
    H, W, D = mask.shape
    series_uid = dcm.generate_uid()
    for k in range(D):
        ds = _base_dataset("VENTJAX^PHANTOM")
        ds.SOPClassUID = dcm.MR_STORAGE
        ds.SeriesInstanceUID = series_uid
        ds.SOPInstanceUID = dcm.generate_uid()
        ds.Rows = H
        ds.Columns = W
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.BitsAllocated = 16
        ds.BitsStored = 16
        ds.HighBit = 15
        ds.PixelRepresentation = 0
        ds.InstanceNumber = k + 1
        ds.SliceLocation = float(k * vox[2])
        ds.PixelSpacing = dcm.MultiValue([float(vox[0]), float(vox[1])])
        ds.SpacingBetweenSlices = float(vox[2])
        ds.add((0x7FE0, 0x0010), "OW",
               mask[:, :, k].astype("<u2").tobytes())
        ds.save_as(os.path.join(folder, f"slice_{k:03d}.dcm"))


def write_study(
    root: str,
    phantom: Optional[Phantom] = None,
    shape: Tuple[int, int, int] = (64, 64, 8),
    vox: Tuple[float, float, float] = (1.5, 1.5, 10.0),
    seed: int = 0,
    with_proton: bool = True,
) -> Phantom:
    """Write a full synthetic study (xenon.dcm, mask/, proton.dcm) to root."""
    ph = phantom or make_phantom(shape=shape, vox=vox, seed=seed)
    os.makedirs(root, exist_ok=True)
    write_multiframe(os.path.join(root, "xenon.dcm"), ph.hp, ph.vox)
    write_mask_folder(os.path.join(root, "mask"), ph.mask, ph.vox)
    if with_proton:
        write_multiframe(
            os.path.join(root, "proton.dcm"), ph.proton, ph.vox,
            name="VENTJAX^PHANTOM",
        )
    return ph
