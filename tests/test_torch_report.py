"""ventjax_torch's report leaves (report/parula.py, montage.py,
histogram.py, screenshot.py) and the rest of its export layer
(report/export.py: defect-overlay DICOMs, NPZ and pickle artifacts, the
filename grammar) against ventjax's, on the same inputs.

Tolerances: every array exact (the same NumPy arithmetic); PNGs equal pixel
for pixel (the screenshot prints today's date, so both are written in the
same test); exported DICOMs with equal pixel data and headers equal except
the fresh UIDs; artifacts written by either package load in the other with
equal contents.
"""
import dataclasses
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest

from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.io import dicom as jdcm
from ventjax.report import export as jexport
from ventjax.report import histogram as jhist
from ventjax.report import montage as jmon
from ventjax.report import parula as jparula
from ventjax.report import screenshot as jshot
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io import dicom as tdcm
from ventjax_torch.io.phantom import make_phantom
from ventjax_torch.io.synthetic import write_study
from ventjax_torch.oracle.reference import calculate_border
from ventjax_torch.report import export as texport
from ventjax_torch.report import histogram as thist
from ventjax_torch.report import montage as tmon
from ventjax_torch.report import parula as tparula
from ventjax_torch.report import screenshot as tshot

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


@pytest.fixture(scope="module")
def ph():
    return make_phantom(shape=(32, 32, 4), seed=1)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_parula_table_equal():
    assert tparula.PARULA_64.dtype == jparula.PARULA_64.dtype
    assert np.array_equal(tparula.PARULA_64, jparula.PARULA_64)


def test_montage_helpers_equal(ph):
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(6, 5, 7))
    for grid in (None, (2, 4), (1, 7)):
        assert np.array_equal(tmon.montage(vol, grid), jmon.montage(vol, grid))
    with pytest.raises(ValueError, match="cannot hold"):
        tmon.montage(vol, (2, 3))
    assert np.array_equal(tmon.montage_row(vol), jmon.montage_row(vol))
    for kw in ({}, {"n_rows": 2}, {"n_cols": 3}, {"same_scale": True}):
        assert np.array_equal(tmon.make_montage(vol, **kw),
                              jmon.make_montage(vol, **kw)), kw
    a, b = ph.hp[:, :, 1], ph.true_defect[:, :, 1]
    assert np.array_equal(tmon.color_binary(a, b), jmon.color_binary(a, b))


@pytest.mark.parametrize("with_optional", [True, False])
def test_montage_rgb_equal(ph, with_optional):
    kw = dict(hp=ph.hp, mask=ph.mask, mask_border=calculate_border(ph.mask),
              n4=ph.hp * 1.1, defect=ph.true_defect,
              ci_map=ph.true_defect * 45.0 if with_optional else None,
              proton=ph.proton if with_optional else None)
    got = tshot.montage_rgb(**kw)
    want = jshot.montage_rgb(**kw)
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    mask = np.zeros_like(ph.mask)
    mask[0, 10:20, 1:3] = 1.0
    with pytest.raises(ValueError, match="row 0"):
        tshot.montage_rgb(**dict(kw, mask=mask))


def test_screenshot_png_equal(ph, tmp_path):
    kw = dict(hp=ph.hp, mask=ph.mask, mask_border=calculate_border(ph.mask),
              n4=ph.hp, defect=ph.true_defect, ci_map=ph.true_defect * 12.0,
              proton=ph.proton,
              metadata={"PatientName": "X", "VDP": 5.2, "LungVolume": 0.1,
                        "DefectVolume": 0.01, "CI": 12.0},
              version="test")
    got = tshot.screenshot(str(tmp_path / "t.png"), **kw)
    want = jshot.screenshot(str(tmp_path / "j.png"), **kw)
    assert np.array_equal(_png(got), _png(want))


def test_report_pngs_without_pillow_raise(ph, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="Pillow"):
        tshot.screenshot(
            str(tmp_path / "s.png"), hp=ph.hp, mask=ph.mask,
            mask_border=calculate_border(ph.mask), n4=ph.hp,
            defect=ph.true_defect, ci_map=None, proton=None, metadata={},
            version="test")
    with pytest.raises(ImportError, match="Pillow"):
        thist.signal_histogram(str(tmp_path / "h.png"), ph.hp, ph.mask)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("route", ["matplotlib", "pil"])
def test_signal_histogram_png_equal(route, tmp_path, monkeypatch):
    if route == "matplotlib":
        pytest.importorskip("matplotlib")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(5)
    sig = rng.gamma(4.0, 200.0, (48, 40, 6))
    mask = np.zeros_like(sig)
    mask[10:38, 8:32, 1:5] = 1
    got = thist.signal_histogram(str(tmp_path / "t.png"), sig, mask,
                                 vdp_lb=7.3, title="T")
    want = jhist.signal_histogram(str(tmp_path / "j.png"), sig, mask,
                                  vdp_lb=7.3, title="T")
    assert np.array_equal(_png(got), _png(want))
    with pytest.raises(ValueError, match="empty mask"):
        thist.signal_histogram(str(tmp_path / "e.png"), sig,
                               np.zeros_like(sig))


# ------------------------------------------------------------ export layer

@pytest.fixture(scope="module")
def xenon(tmp_path_factory):
    root = tmp_path_factory.mktemp("report_study")
    p = write_study(str(root), shape=(16, 16, 4), seed=2)
    return str(root / "xenon.dcm"), p


_UIDS = ("SOPInstanceUID", "SeriesInstanceUID", "MediaStorageSOPInstanceUID")


def _header(ds):
    return {k: v for k, v in tdcm.dicom_to_dict(ds, True).items()
            if k not in _UIDS}


@pytest.mark.parametrize("for_pacs", [True, False])
@pytest.mark.parametrize("syntax", ["explicit", "rle"])
def test_export_dicom_equal(xenon, tmp_path, for_pacs, syntax):
    path, p = xenon
    n4 = p.hp * 1.3
    out = {}
    for name, dcm, mod in (("t", tdcm, texport), ("j", jdcm, jexport)):
        ts = dcm.RLE_LOSSLESS if syntax == "rle" else dcm.EXPLICIT_VR_LE
        os.makedirs(tmp_path / name)
        ds, _ = dcm.open_single_dicom(path)
        out[name] = mod.export_dicom(
            ds, n4, p.true_defect, str(tmp_path / name), optional_text="g",
            for_pacs=for_pacs, vdp=5.25, patient_name="P",
            transfer_syntax=ts)
    if for_pacs:
        files = sorted(os.listdir(out["t"]))
        assert files == sorted(os.listdir(out["j"])) \
            == [f"dicom_{i}.dcm" for i in range(4)]
        pairs = [(os.path.join(out["t"], f), os.path.join(out["j"], f))
                 for f in files]
    else:
        pairs = [(out["t"], out["j"])]
    for tp, jp in pairs:
        got, want = tdcm.read_file(tp), tdcm.read_file(jp)
        assert np.array_equal(got.pixel_array, want.pixel_array)
        assert _header(got) == _header(want)
    assert np.array_equal(texport._defect_rgb(n4, p.true_defect),
                          jexport._defect_rgb(n4, p.true_defect))


def _state(xenon_ds_mod):
    return {
        "version": "241007_vent",
        "HPvent": np.arange(24.0).reshape(2, 3, 4),
        "mask": np.ones((2, 3, 4), np.uint8),
        "metadata": {"PatientName": "P^Q", "VDP": 7.5, "CI": np.float64(3.0)},
        "vox": [1.5, 1.5, 10.0],
        "flag": np.bool_(True),
        "ds": xenon_ds_mod,
        "notes": None,
    }


@pytest.mark.parametrize("writer", ["port", "ventjax"])
def test_npz_round_trip_both_ways(xenon, tmp_path, writer):
    path, _ = xenon
    w, r = (texport, jexport) if writer == "port" else (jexport, texport)
    cfg_w = (DEFAULT_CONFIG if writer == "port"
             else JAX_DEFAULT_CONFIG).replace(ci_rmax=20)
    dcm = tdcm if writer == "port" else jdcm
    state = dict(_state(dcm.open_single_dicom(path)[0]), config=cfg_w)
    p = w.save_npz(state, str(tmp_path / "a"))
    assert p.endswith(".npz")
    for loader in (r.load_npz, w.load_npz):
        back = loader(p)
        assert np.array_equal(back["HPvent"], state["HPvent"])
        assert back["mask"].dtype == np.uint8
        assert back["metadata"] == {"PatientName": "P^Q", "VDP": 7.5,
                                    "CI": 3.0}
        # an np.bool_ scalar is recorded by str(), in both packages
        assert back["vox"] == [1.5, 1.5, 10.0] and back["flag"] == "True"
        assert "ds" not in back and back["notes"] is None
        assert dataclasses.asdict(back["config"]) == \
            dataclasses.asdict(cfg_w)


def test_load_npz_rejects_bad_files(tmp_path):
    bad = tmp_path / "x.npz"
    bad.write_bytes(b"junk")
    with pytest.raises(ValueError, match="no zip magic"):
        texport.load_npz(str(bad))
    np.savez(str(tmp_path / "plain.npz"), a=np.zeros(2))
    with pytest.raises(ValueError, match="missing"):
        texport.load_npz(str(tmp_path / "plain.npz"))
    p = texport.save_npz({"a": np.zeros(2)}, str(tmp_path / "v.npz"))
    with np.load(p) as z:
        man = json.loads(str(z["__ventjax_artifact__"]))
    man["artifact_version"] = 99
    np.savez(p, a=np.zeros(2), __ventjax_artifact__=np.asarray(
        json.dumps(man)))
    with pytest.raises(ValueError, match="artifact_version 99"):
        texport.load_npz(p)
    with open(tmp_path / "trunc.npz", "wb") as f:
        f.write(open(p, "rb").read()[:60])
    with pytest.raises(ValueError):
        texport.load_npz(str(tmp_path / "trunc.npz"))


@pytest.mark.parametrize("writer", ["port", "ventjax"])
def test_pickle_round_trip_both_ways(xenon, tmp_path, writer):
    path, _ = xenon
    w, r = (texport, jexport) if writer == "port" else (jexport, texport)
    dcm = tdcm if writer == "port" else jdcm
    ds = dcm.open_single_dicom(path)[0]
    state = dict(_state(ds), bad=lambda x: x)
    p = w.save_pickle(state, str(tmp_path / "s.pkl"))
    back = r.load_pickle(p)
    assert "bad" not in back
    assert np.array_equal(back["HPvent"], state["HPvent"])
    assert back["metadata"] == state["metadata"]
    assert type(back["ds"]).__name__ == "Dataset"
    assert tdcm.dicom_to_dict(back["ds"], True) == \
        tdcm.dicom_to_dict(tdcm.read_file(path), True)
    if writer == "ventjax":
        # read as the port's own class, not by importing the writer's
        assert type(back["ds"]) is tdcm.Dataset


def _write_referencelike_pickle(path):
    """A pickle whose byte stream references pydicom.dataset.FileDataset,
    as one written by the reference app on a machine with pydicom."""
    mod = types.ModuleType("pydicom.dataset")

    class FileDataset:
        def __init__(self):
            self.PatientName = "REF^SUBJECT"

    FileDataset.__module__ = "pydicom.dataset"
    FileDataset.__qualname__ = "FileDataset"
    mod.FileDataset = FileDataset
    pkg = types.ModuleType("pydicom")
    pkg.dataset = mod
    sys.modules["pydicom"] = pkg
    sys.modules["pydicom.dataset"] = mod
    try:
        with open(path, "wb") as f:
            pickle.dump({"ds": FileDataset(), "HPvent": np.arange(4.0),
                         "metadata": {"VDP": 7.5}}, f)
    finally:
        del sys.modules["pydicom"]
        del sys.modules["pydicom.dataset"]


def test_reference_app_pickle_is_reported(tmp_path):
    p = str(tmp_path / "ref.pkl")
    _write_referencelike_pickle(p)
    with pytest.raises(texport.ReferencePickleError) as ei:
        texport.load_pickle(p)
    assert "pydicom" in str(ei.value) and "strip_foreign" in str(ei.value)
    state = texport.load_pickle(p, strip_foreign=True)
    assert isinstance(state["ds"], texport.ForeignStub)
    assert "pydicom.dataset.FileDataset" in repr(state["ds"])
    assert state["metadata"]["VDP"] == 7.5
    from ventjax_torch.compat import Vent_Analysis

    with pytest.raises(texport.ReferencePickleError):
        Vent_Analysis(pickle_path=p, device="cpu")


@pytest.mark.parametrize("irb,fields", [
    ("mepo", dict(mepo_id="0039", visit=1, treatment="preAlb")),
    ("mepo", dict(mepo_id="0039", treatment="postAlb")),
    ("mepo", dict()),
    ("genxe", dict(genxe_id="0012", treatment="postAlbuterol")),
    ("genxe", dict(genxe_id="0012", treatment="preSildenafil")),
    ("GenXe", dict(treatment="none")),
    ("clinical", dict(clinical_id="AB", visit=2, treatment="Albuterol")),
    ("clinical", dict(clinical_id="AB", treatment="baseline")),
    ("clinical", dict(clinical_id="AB")),
])
def test_study_filename_matches_ventjax(irb, fields):
    md = {"StudyDate": "20240301"}
    assert texport.study_filename(irb, md, **fields) == \
        jexport.study_filename(irb, md, **fields)


def test_study_filename_unknown_irb():
    with pytest.raises(ValueError, match="unknown IRB"):
        texport.study_filename("nope", {})


def test_study_presets_match_ventjax():
    from ventjax import config as jconfig
    from ventjax_torch import config as tconfig

    assert tconfig.REFERENCE_VERSION == jconfig.REFERENCE_VERSION
    assert sorted(tconfig.STUDY_PRESETS) == sorted(jconfig.STUDY_PRESETS)
    for name, want in jconfig.STUDY_PRESETS.items():
        got = tconfig.preset(name.upper())
        for f in dataclasses.fields(want):
            if f.name != "config":
                assert getattr(got, f.name) == getattr(want, f.name)
        assert dataclasses.asdict(got.config) == \
            dataclasses.asdict(want.config)
    with pytest.raises(ValueError, match="treatment"):
        tconfig.preset("mepo").validate(treatment="postAlbuterol")
    with pytest.raises(ValueError, match="visit"):
        tconfig.preset("mepo").validate(visit="9")
    with pytest.raises(KeyError, match="unknown study preset"):
        tconfig.preset("nope")
