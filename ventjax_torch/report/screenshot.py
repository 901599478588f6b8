"""Annotated report screenshot — the 7-row RGB montage PNG.

The port's copy of ``ventjax/report/screenshot.py``.  ``montage_rgb`` is
NumPy only; Pillow is imported inside ``screenshot`` and the font helpers
(``_pil``), which raise an ImportError naming Pillow where it is absent.

Layout parity with the reference screenShot (Vent_Analysis.py:458-520):
rows = [blank, blank, proton, HPvent, N4 + green mask border,
N4 + red defect overlay, N4 + parula-colored CI], cropped to the mask bbox
with a 5-voxel border, annotated with patient/study/metric text.

Deviations (documented):
- the parula index int(CI*64/40) is clamped to [0,63] (the reference
  IndexErrors for CI > ~39.4 mm);
- fonts fall back from arial.ttf to DejaVu/default (no Windows fonts here).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np

from ventjax_torch.oracle.reference import crop_to_data, normalize
from ventjax_torch.report.parula import PARULA_64


_FONT_CACHE: Dict[int, object] = {}


def _pil():
    """(Image, ImageDraw, ImageFont) of Pillow, imported on first use."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(
            "writing a PNG report (screenshot, histogram) needs Pillow, "
            "which is not installed") from e
    return Image, ImageDraw, ImageFont


def _font(size: int):
    # resolved once per size: the probe chain (failed arial.ttf, possible
    # matplotlib import) otherwise reruns for every text draw — ~23 times
    # per screenshot, hundreds of times per cohort
    if size in _FONT_CACHE:
        return _FONT_CACHE[size]
    _FONT_CACHE[size] = _resolve_font(size)
    return _FONT_CACHE[size]


def _resolve_font(size: int):
    ImageFont = _pil()[2]
    for name in ("arial.ttf", "DejaVuSans.ttf"):
        try:
            return ImageFont.truetype(name, size=size)
        except Exception:
            pass
    try:
        import matplotlib
        path = os.path.join(
            os.path.dirname(matplotlib.__file__),
            "mpl-data", "fonts", "ttf", "DejaVuSans.ttf",
        )
        return ImageFont.truetype(path, size=size)
    except Exception:
        return ImageFont.load_default()


def montage_rgb(
    hp: np.ndarray,
    mask: np.ndarray,
    mask_border: np.ndarray,
    n4: np.ndarray,
    defect: np.ndarray,
    ci_map: Optional[np.ndarray],
    proton: Optional[np.ndarray],
    crop_border: int = 5,
    parula_num: int = 64,
    parula_den: int = 40,
):
    """The pre-annotation [H*7, W*n_slices, 3] float montage plus the crop
    index lists — the pure-array core of screenShot (Vent_Analysis.py:
    458-494), split out so it can be compared bitwise with the reference
    package's without drawing."""
    # crop_to_data pins the reference's index-0 quirk (row/col/slice 0 can
    # never be kept, Vent_Analysis.py:433-440): a mask whose signal lives
    # ONLY at index 0 on some axis would IndexError deep inside.  Check
    # here so the montage fails with an actionable message instead.
    for ax, name in ((0, "row"), (1, "col"), (2, "slice")):
        other = tuple(i for i in range(3) if i != ax)
        hit = np.where(mask.sum(axis=other) > 0)[0]
        if hit.size and hit.max() == 0:
            raise ValueError(
                f"mask signal exists only at {name} 0; the reference's "
                "cropToData can never keep index 0 (Vent_Analysis.py:"
                "433-440) so no screenshot can be produced — shift or pad "
                "the volume by one voxel on that axis")
    _, rr, cc, ss = crop_to_data(mask, border=crop_border)
    ix = np.ix_(rr, cc, ss)

    blank = np.zeros_like(hp[ix])
    prot = normalize(proton[ix]) if proton is not None and np.shape(proton) == hp.shape else blank
    hpn = normalize(hp[ix])
    n4n = normalize(n4[ix])
    border = normalize(mask_border[ix]) > 0
    dA = defect[ix] > 0
    ci = ci_map[ix] if ci_map is not None and np.shape(ci_map) == hp.shape else blank

    idx = np.clip((ci * parula_num / parula_den).astype(int), 0, 63)
    ci_rgb = PARULA_64[idx]  # [h, w, d, 3]

    def stack_rows(chan):
        red = chan == 0
        ci_c = n4n * (ci == 0) + ci_rgb[..., chan] * (ci > 0)
        # reference border weights: R=0, G=1, B=1 (cyan outline),
        # Vent_Analysis.py:487-489
        border_row = n4n * (~border) + (0.0 if red else 1.0) * border
        defect_row = n4n * (~dA) + (dA if red else 0)
        return np.concatenate(
            (blank, blank, prot, hpn, border_row, defect_row, ci_c), axis=2
        )

    n_slices = n4n.shape[2]
    from ventjax_torch.report.montage import montage
    chans = [montage(stack_rows(c), grid_shape=(7, n_slices)) for c in range(3)]
    return np.stack(chans, axis=2), rr, cc, ss


def screenshot(
    path: str,
    hp: np.ndarray,
    mask: np.ndarray,
    mask_border: np.ndarray,
    n4: np.ndarray,
    defect: np.ndarray,
    ci_map: Optional[np.ndarray],
    proton: Optional[np.ndarray],
    metadata: Dict,
    version: str,
    crop_border: int = 5,
    parula_num: int = 64,
    parula_den: int = 40,
) -> str:
    """Write the annotated montage PNG; returns the path."""
    Image, ImageDraw, _ = _pil()
    image_arr, rr, cc, ss = montage_rgb(
        hp, mask, mask_border, n4, defect, ci_map, proton,
        crop_border=crop_border, parula_num=parula_num,
        parula_den=parula_den,
    )
    n4n_shape = (len(rr), len(cc), len(ss))

    img = Image.fromarray(np.uint8(np.clip(image_arr, 0, 1) * 255))
    draw = ImageDraw.Draw(img)
    h0, w0 = n4n_shape[0], n4n_shape[1]
    for k in ss:
        draw.text((k * w0 - w0 / 2, h0 * 1.8), f"{k + 1}",
                  fill=(255, 255, 255), font=_font(30))
    md = metadata
    W = image_arr.shape[1]
    rows = [
        (10, 0.10, 40, f"Patient: {md.get('PatientName','')} ({md.get('PatientAge','')}/{md.get('PatientSex','')})"),
        (10, 0.40, 35, f"Disease: {md.get('Disease','')}"),
        (10, 0.70, 35, f"StudyDate: {md.get('StudyDate','')}"),
        (10, 1.00, 35, f"Visit#: {md.get('visit','')}"),
        (10, 1.30, 35, f"Treatment: {md.get('treatment','')}"),
        (round(W * .25), 0.10, 35, f"Lung Volume: {_round_ml(md.get('LungVolume'))} mL"),
        (round(W * .25), 0.40, 35, f"Defect Volume: {_round_ml(md.get('DefectVolume'))} mL"),
        (round(W * .50), 0.10, 35, f"DE: {md.get('DE','')} mL"),
        (round(W * .50), 0.40, 35, f"FEV1: {md.get('FEV1','')} %"),
        (round(W * .50), 0.70, 35, f"VDP: {_round1(md.get('VDP'))} %"),
        (round(W * .50), 1.00, 35, f"CI: {_round0(md.get('CI'))} %"),
        (round(W * .75), 0.25, 35, f"Analysis Version: {version}"),
        (round(W * .75), 0.50, 35,
         f"Analyzed by: {md.get('analysisUser','')} on "
         f"{str(datetime.datetime.today()).split()[0]}"),
    ]
    for x, yf, size, text in rows:
        draw.text((x, h0 * yf), text, fill=(255, 255, 255), font=_font(size))
    img.save(path, "PNG")
    return path


def _round_ml(v):
    try:
        return np.round(float(v) * 1000)
    except (TypeError, ValueError):
        return ""


def _round1(v):
    try:
        return np.round(float(v), 1)
    except (TypeError, ValueError):
        return ""


def _round0(v):
    try:
        return np.round(float(v))
    except (TypeError, ValueError):
        return ""
