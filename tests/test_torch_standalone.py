"""ventjax_torch stands on its own: its copies of the reference package's
config, geometry tables, phantoms, DICOM and NIfTI codecs and exports give
the reference's values, and neither the package nor chip_smoke.py imports
the reference package.  The JPEG-family decode is held to the reference's on
the fixtures of tests/test_io_jpeg.py, which Pillow encodes in-process.

Tolerances: none; every comparison is exact (the copies run the same
NumPy arithmetic, and files are compared array for array).
"""
import ast
import dataclasses
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ventjax import config as jconfig
from ventjax.io import dicom as jdicom
from ventjax.io import nifti as jnifti
from ventjax.io import phantom as jphantom
from ventjax.io import synthetic as jsynthetic
from ventjax.oracle import ci_oracle, n4_oracle
from ventjax.report import export as jexport
from ventjax_torch import config as tconfig
from ventjax_torch.io import dicom as tdicom
from ventjax_torch.io import nifti as tnifti
from ventjax_torch.io import phantom as tphantom
from ventjax_torch.io import synthetic as tsynthetic
from ventjax_torch.ops import geometry
from ventjax_torch.pipeline import cohort as tc
from ventjax_torch.report import export as texport

REPO = Path(__file__).resolve().parent.parent
SHAPE = (24, 20, 4)


def test_config_fields_and_defaults_match():
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(tconfig.VentConfig)]
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(jconfig.VentConfig)]
    assert tf == jf
    assert dataclasses.asdict(tconfig.DEFAULT_CONFIG) == dataclasses.asdict(
        jconfig.DEFAULT_CONFIG)
    import ventjax_torch
    assert ventjax_torch.DEFAULT_CONFIG is tconfig.DEFAULT_CONFIG
    assert ventjax_torch.VentConfig is tconfig.VentConfig


@pytest.mark.parametrize("n_elements", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 6, 16, 127])
def test_bspline_basis_matches_oracle(n, n_elements):
    np.testing.assert_array_equal(geometry.bspline_basis_1d(n, n_elements),
                                  n4_oracle.bspline_basis_1d(n, n_elements))


def test_next_pow2_padded_matches_oracle():
    for n in (2, 3, 100, 200, 256, 300, 766):
        assert geometry._next_pow2_padded(n) == \
            n4_oracle._next_pow2_padded(n)


@pytest.mark.parametrize("vox,radius", [
    ((1.5, 1.5, 10.0), 12), ((1.5, 1.5, 10.0), 50),
    ((3.125, 3.125, 15.0), 20), ((2.0, 3.0, 5.0), 9), ((1.0, 1.0, 1.0), 6),
])
def test_sphere_table_and_shells_match_oracle(vox, radius):
    got = geometry.sphere_pixels(vox, radius)
    want = ci_oracle.sphere_pixels(vox, radius)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(geometry.shell_structure(got),
                    ci_oracle.shell_structure(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_phantom_bit_equal(seed):
    kw = dict(shape=SHAPE, vox=(1.5, 1.5, 10.0), seed=seed)
    if seed == 17:
        kw.update(n_defects=6, defect_radius_vox=(6.0, 8.0, 10.0))
    got, want = tphantom.make_phantom(**kw), jphantom.make_phantom(**kw)
    for f in dataclasses.fields(jphantom.Phantom):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, f.name)


@pytest.mark.parametrize("seed", [0, 5])
def test_cohort_bit_equal(seed):
    for a, b in zip(tphantom.make_cohort(3, SHAPE, seed=seed),
                    jphantom.make_cohort(3, SHAPE, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _same_dataset(a, b):
    assert tdicom.dicom_to_dict(a, True) == jdicom.dicom_to_dict(b, True)
    np.testing.assert_array_equal(a.pixel_array, b.pixel_array)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_dicom_study_reads_back_across_packages(tmp_path, writer):
    """A study written by one package reads back identically through both
    packages' readers (multi-frame xenon, proton, per-slice mask)."""
    ph = jphantom.make_phantom(shape=SHAPE, seed=4)
    write = (tsynthetic if writer == "port" else jsynthetic).write_study
    write(str(tmp_path), phantom=ph)
    for name in ("xenon.dcm", "proton.dcm"):
        path = str(tmp_path / name)
        (ds_t, vol_t), (ds_j, vol_j) = (tdicom.open_single_dicom(path),
                                        jdicom.open_single_dicom(path))
        np.testing.assert_array_equal(vol_t, vol_j)
        _same_dataset(ds_t, ds_j)
    folder = str(tmp_path / "mask")
    (ds_t, m_t), (ds_j, m_j) = (tdicom.open_dicom_folder(folder),
                                jdicom.open_dicom_folder(folder))
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(m_t, ph.mask)
    _same_dataset(ds_t, ds_j)


@pytest.mark.parametrize("syntax", ["explicit", "rle"])
def test_dicom_files_byte_equal(tmp_path, syntax):
    """One dataset written by both packages' writers gives the same bytes
    (the UIDs are set, not generated, so nothing differs)."""
    paths = []
    for mod in (tdicom, jdicom):
        ds = mod.Dataset()
        ds.SOPClassUID = mod.MR_STORAGE
        ds.SOPInstanceUID = "1.2.3.4"
        ds.Rows, ds.Columns, ds.NumberOfFrames = 6, 5, 3
        ds.BitsAllocated, ds.SamplesPerPixel = 16, 1
        ds.PixelSpacing = mod.MultiValue([1.5, 1.5])
        ds.add((0x7FE0, 0x0010), "OW",
               (np.arange(90, dtype="<u2") * 37).tobytes())
        path = str(tmp_path / f"{mod.__name__}.dcm")
        ds.save_as(path, transfer_syntax=getattr(
            mod, "RLE_LOSSLESS" if syntax == "rle" else "EXPLICIT_VR_LE"))
        paths.append(path)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    _same_dataset(tdicom.read_file(paths[1]), jdicom.read_file(paths[0]))


def test_exports_equal(tmp_path):
    """export_nifti, dicom_to_json and save_npz of the port write what the
    reference's write, read back through both NIfTI readers."""
    gen = np.random.default_rng(1)
    arrs = {k: gen.random(SHAPE).astype(np.float32)
            for k in ("hp", "mask", "proton", "n4", "defect", "ci")}
    hp, mask = arrs.pop("hp"), arrs.pop("mask")
    ph = jphantom.make_phantom(shape=SHAPE, seed=2)
    jsynthetic.write_study(str(tmp_path / "study"), phantom=ph,
                           with_proton=False)
    ds = jdicom.read_file(str(tmp_path / "study" / "xenon.dcm"))
    for tag, mod in (("t", texport), ("j", jexport)):
        d = tmp_path / tag
        d.mkdir()
        path = mod.export_nifti(str(d), "s", hp, mask, **arrs)
        assert path == str(d / "s_dataArray.nii")
        mod.dicom_to_json(ds, str(d / "s.json"))
        state = {"HPvent": hp, "mask": mask, "vox": [1.5, 1.5, 10.0],
                 "metadata": {"VDP": 1.25},
                 "config": (tconfig if tag == "t" else jconfig).DEFAULT_CONFIG}
        mod.save_npz(state, str(d / "s.npz"))
    for reader in (tnifti.load, jnifti.load):
        a, aff_a = reader(str(tmp_path / "t" / "s_dataArray.nii"))
        b, aff_b = reader(str(tmp_path / "j" / "s_dataArray.nii"))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(aff_a, aff_b)
    np.testing.assert_array_equal(
        texport.build_4d_array(hp, mask, **arrs),
        jexport.build_4d_array(hp, mask, **arrs))
    assert json.load(open(tmp_path / "t" / "s.json")) == json.load(
        open(tmp_path / "j" / "s.json"))
    with np.load(tmp_path / "t" / "s.npz", allow_pickle=False) as zt, \
            np.load(tmp_path / "j" / "s.npz", allow_pickle=False) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], k)
    back = jexport.load_npz(str(tmp_path / "t" / "s.npz"))
    assert back["config"] == jconfig.DEFAULT_CONFIG


def _jpeg_case(kind, tmp_path):
    """One JPEG-family file of tests/test_io_jpeg.py, encoded in-process by
    Pillow; returns its path."""
    from test_io_jpeg import j2k_encode, jpeg_encode, smooth16, write_encap_file

    rng = np.random.default_rng(42)
    path = str(tmp_path / f"{kind}.dcm")
    j2k = jdicom.JPEG2000_LOSSLESS
    if kind == "j2k16_multiframe":
        frames = smooth16(rng, (4, 32, 40))
        write_encap_file(path, j2k, [j2k_encode(f) for f in frames],
                         rows=32, cols=40, nframes=4, bits=16)
    elif kind == "j2k8_single":
        frame = rng.integers(0, 255, (16, 24)).astype(np.uint8)
        write_encap_file(path, j2k, [j2k_encode(frame)],
                         rows=16, cols=24, nframes=1, bits=8)
    elif kind == "baseline_gray_multiframe":
        frames = (smooth16(rng, (3, 24, 24), top=250) & 0xFF).astype(np.uint8)
        write_encap_file(path, jdicom.JPEG_BASELINE,
                         [jpeg_encode(f) for f in frames],
                         rows=24, cols=24, nframes=3, bits=8)
    elif kind == "baseline_rgb":
        frame = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
        write_encap_file(path, jdicom.JPEG_BASELINE,
                         [jpeg_encode(frame, quality=90)],
                         rows=16, cols=16, nframes=1, samples=3, bits=8)
    elif kind == "split_fragments":
        stream = j2k_encode(smooth16(rng, (1, 32, 32))[0])
        cut = (len(stream) // 2) & ~1
        write_encap_file(path, j2k, [stream[:cut], stream[cut:]],
                         rows=32, cols=32, nframes=1, bits=16)
    elif kind == "bot_grouping":
        frags, bounds, pos = [], [], 0
        for f in smooth16(rng, (2, 24, 24)):
            s = j2k_encode(f)
            s += b"\x00" * (len(s) % 2)
            cut = (len(s) // 2) & ~1
            bounds.append(pos)
            frags += [s[:cut], s[cut:]]
            pos += 16 + len(s)
        write_encap_file(path, j2k, frags, rows=24, cols=24, nframes=2,
                         bits=16, bot=struct.pack("<2I", *bounds))
    elif kind == "fragment_frame_mismatch":
        frames = smooth16(rng, (2, 16, 16))
        s0, s1 = j2k_encode(frames[0]), j2k_encode(frames[1])
        cut = (len(s1) // 2) & ~1
        write_encap_file(path, j2k, [s0, s1[:cut], s1[cut:]],
                         rows=16, cols=16, nframes=2, bits=16)
    elif kind == "misaligned_bot":
        frags = [j2k_encode(f) for f in smooth16(rng, (2, 16, 16))]
        write_encap_file(path, j2k, frags + [b"\x00\x00"], rows=16, cols=16,
                         nframes=2, bits=16, bot=struct.pack("<2I", 0, 7))
    elif kind == "corrupt_stream":
        write_encap_file(path, jdicom.JPEG_BASELINE,
                         [b"\xff\xd8notajpeg\x00"],
                         rows=8, cols=8, nframes=1, bits=8)
    elif kind == "header_size_mismatch":
        frame = rng.integers(0, 255, (16, 16)).astype(np.uint8)
        write_encap_file(path, jdicom.JPEG_BASELINE, [jpeg_encode(frame)],
                         rows=32, cols=32, nframes=1, bits=8)
    elif kind == "jpeg_lossless":
        write_encap_file(path, "1.2.840.10008.1.2.4.70", [b"\xff\xd8\x00\x00"],
                         rows=8, cols=8, nframes=1, bits=16)
    else:
        raise KeyError(kind)
    return path


@pytest.mark.parametrize("kind", [
    "j2k16_multiframe", "j2k8_single", "baseline_gray_multiframe",
    "baseline_rgb", "split_fragments", "bot_grouping"])
def test_jpeg_decode_equals_reference(tmp_path, kind):
    pytest.importorskip("PIL")
    path = _jpeg_case(kind, tmp_path)
    got, want = (tdicom.read_file(path).pixel_array,
                 jdicom.read_file(path).pixel_array)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    _, vol = tdicom.open_single_dicom(path)
    np.testing.assert_array_equal(vol, jdicom.open_single_dicom(path)[1])
    # re-save transcodes to native Explicit VR LE in both writers
    saved = []
    for mod in (tdicom, jdicom):
        out = str(tmp_path / f"resaved_{mod.__name__}.dcm")
        mod.read_file(path).save_as(out)
        saved.append(Path(out).read_bytes())
    assert saved[0] == saved[1]
    back = tdicom.read_file(str(tmp_path / f"resaved_{tdicom.__name__}.dcm"))
    assert not isinstance(back.get("PixelData"), tdicom.EncapsulatedPixelData)
    np.testing.assert_array_equal(back.pixel_array, want)


@pytest.mark.parametrize("kind,match", [
    ("fragment_frame_mismatch", "cannot map 3"),
    ("misaligned_bot", "Offset Table"),
    ("corrupt_stream", "Pillow could not decode"),
    ("header_size_mismatch", "header claims"),
    ("jpeg_lossless", "unsupported transfer syntax"),
])
def test_jpeg_malformed_raises_in_both(tmp_path, kind, match):
    pytest.importorskip("PIL")
    path = _jpeg_case(kind, tmp_path)
    for mod in (tdicom, jdicom):
        ds = mod.read_file(path)
        with pytest.raises(ValueError, match=match):
            ds.pixel_array


def test_jpeg_decode_without_pillow_raises(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    path = _jpeg_case("j2k8_single", tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    ds = tdicom.read_file(path)
    with pytest.raises(ValueError, match="needs Pillow, which is not installed"):
        ds.pixel_array


def test_run_cohort_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tc.run_cohort([], str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tc._GeometryRunner(SHAPE, (1.5, 1.5, 10.0), tconfig.DEFAULT_CONFIG, 1)
    assert not (tmp_path / "out").exists()
    assert tc.run_cohort([], str(tmp_path / "cpu"), device="cpu") == []


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _module_level_imports(path):
    """Modules imported by the statements of the module body itself (not
    inside a function or class)."""
    names = []
    for node in ast.parse(Path(path).read_text()).body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                break
            if isinstance(sub, ast.Import):
                names += [a.name for a in sub.names]
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                names.append(sub.module)
    return names


_PORT_FILES = ["chip_smoke.py"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "ventjax_torch").rglob("*.py"))


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_import_of_ventjax(path):
    """No import of jax, flax, optax, orbax or ventjax anywhere in the port,
    and none of PIL or matplotlib at module level (the drawing functions
    import them)."""
    names = _imported_modules(REPO / path)
    bad = [n for n in names if n.split(".")[0] in ("ventjax", "jax", "jaxlib",
                                                   "flax", "optax", "orbax")]
    assert not bad, bad
    drawing = [n for n in _module_level_imports(REPO / path)
               if n.split(".")[0] in ("PIL", "matplotlib")]
    assert not drawing, drawing


def test_import_guard_covers_the_facade_modules():
    for path in ("compat/vent_analysis.py", "compat/ci_module.py",
                 "report/screenshot.py", "report/histogram.py",
                 "ops/morphology.py", "ops/fft_recon.py", "io/twix.py",
                 "oracle/ci_oracle.py", "models/segmentation.py",
                 "io/phantom_oof.py", "dist/halo.py", "dist/mesh.py",
                 "gui/__init__.py", "gui/controller.py", "gui/app.py",
                 "ops/n4_field_cuda.py"):
        assert f"ventjax_torch/{path}" in _PORT_FILES, path
    # the checker sees the reference's module-level PIL import, and its
    # segmentation module's flax and optax
    assert "PIL" in _module_level_imports(REPO / "ventjax/report/screenshot.py")
    seg = _module_level_imports(REPO / "ventjax/models/segmentation.py")
    assert "flax.linen" in seg and "optax" in seg


@pytest.mark.parametrize("path", ["ventjax_torch/gui/app.py",
                                  "ventjax_torch/gui/controller.py",
                                  "ventjax_torch/gui/__init__.py"])
def test_gui_imports_no_toolkit_at_module_level(path):
    """The port's GUI imports nothing of ventjax (the AST walk above) and
    imports tkinter and Pillow only inside the functions that draw, so it
    imports on a machine without a display or either library; ventjax's
    view does the same."""
    mod = _module_level_imports(REPO / path)
    assert not [n for n in mod if n.split(".")[0] in ("tkinter", "PIL")], mod
    ref = _module_level_imports(REPO / path.replace("ventjax_torch/",
                                                    "ventjax/"))
    assert not [n for n in ref if n.split(".")[0] in ("tkinter", "PIL")]
    assert "tkinter" in _imported_modules(REPO / "ventjax_torch/gui/app.py")
