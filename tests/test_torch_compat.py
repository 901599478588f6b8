"""ventjax_torch's Vent_Analysis facade (compat/), its CI module and the
``analyze`` / ``export`` / ``twix`` commands, on the CPU (``device="cpu"``),
against ventjax's facade and CLI on the same written study.

Tolerances: defect arrays (mean-anchored, linear-binning, k-means) exact;
|ΔVDP|, |ΔVDP_lb|, |ΔVDP_km| <= 0.1 percentage points; SNR within 1e-4
relative; the CI map within 2e-5 mm and the subject CI equal; N4 within
2e-3 of its largest value (the suite's bf16-fit envelope, as in
tests/test_torch_n4.py); the CI module's helpers bit-equal.  The study is
64x64x8; ventjax compiles each shape once, so every test here reuses it.
"""
import contextlib
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ventjax.cli import main as jax_main
from ventjax.compat import Vent_Analysis as JaxVent
from ventjax.compat import ci_module as jci
from ventjax.compat import extract_attributes as jax_extract
from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.report import export as jexport
from ventjax_torch.cli import main
from ventjax_torch.compat import Vent_Analysis, ci_module, extract_attributes
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io.synthetic import write_study
from ventjax_torch.io.twix import write_synthetic_twix
from ventjax_torch.oracle.ci_oracle import calculate_ci_oracle
from ventjax_torch.report import export as texport

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
VOX = [1.5, 1.5, 10.0]
METRICS = ("SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume", "DefectVolume",
           "CI")


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat_study")
    ph = write_study(str(root), shape=(64, 64, 8), vox=tuple(VOX), seed=6)
    paths = {"xenon_path": f"{root}/xenon.dcm", "mask_path": f"{root}/mask",
             "proton_path": f"{root}/proton.dcm"}
    return paths, ph


@pytest.fixture(scope="module")
def pair(study):
    """(ventjax's facade, the port's facade), both after VDP and CI."""
    paths, _ = study
    jv = JaxVent(**paths)
    jv.calculate_VDP()
    jv.calculate_CI()
    tv = Vent_Analysis(**paths, device="cpu")
    tv.calculate_VDP()
    tv.calculate_CI()
    return jv, tv


def _check_metadata(want, got):
    assert set(want) == set(got)
    for key in want:
        if key in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(got[key] - want[key]) <= 0.1, key
        elif key == "SNR":
            assert got[key] == pytest.approx(want[key], rel=1e-4)
        elif key in ("LungVolume", "DefectVolume", "CI"):
            assert got[key] == pytest.approx(want[key], abs=1e-12), key
        else:
            assert str(got[key]) == str(want[key]), key


# ------------------------------------------------------------------ facade

def test_facade_metadata_matches_ventjax(pair):
    jv, tv = pair
    _check_metadata(jv.metadata, tv.metadata)
    assert tv.metadata["CI"] == jv.metadata["CI"]
    for key in ("SNR", "VDP", "VDP_lb", "VDP_km", "DefectVolume"):
        assert type(tv.metadata[key]) is float
    assert tv.vox == jv.vox == VOX


def test_facade_arrays_match_ventjax(pair):
    jv, tv = pair
    for name in ("defectArray", "defectArrayLB", "defectArrayKM",
                 "defectBorder", "mask_border", "mask"):
        assert np.array_equal(getattr(tv, name), getattr(jv, name)), name
    assert np.abs(tv.CIarray - jv.CIarray).max() <= 2e-5
    n4_err = np.abs(tv.N4HPvent - jv.N4HPvent).max()
    assert n4_err <= 2e-3 * np.abs(jv.N4HPvent).max()
    want = calculate_ci_oracle(tv.defectArray, vox=VOX, rmax=50,
                               saturate=True)
    assert np.abs(tv.CIarray - want).max() <= 2e-5


def test_facade_state_keys_and_dtypes_match_ventjax(pair):
    """The same attribute names with the same types and dtypes (numpy
    attributes), and no torch object in the state: the device is not a
    state key."""
    jv, tv = pair
    assert sorted(vars(tv)) == sorted(vars(jv))
    for name, want in vars(jv).items():
        got = getattr(tv, name)
        assert type(got).__name__ == type(want).__name__, name
        if isinstance(want, np.ndarray):
            assert (got.dtype, got.shape) == (want.dtype, want.shape), name
    assert not any(isinstance(x, (torch.Tensor, torch.device))
                   for x in vars(tv).values())
    assert tv.device == torch.device("cpu")
    assert "ventjax_torch" in repr(tv)


def test_facade_repeat_vdp_is_bit_identical(study):
    paths, _ = study
    v = Vent_Analysis(**paths, device="cpu")
    v.calculate_VDP()
    first = v.N4HPvent.copy()
    v.calculate_VDP()
    assert np.array_equal(first, v.N4HPvent)


def test_kmeans_with_nonpositive_masked_voxels_matches_ventjax(study):
    """Masked voxels with hp <= 0 take part in k-means (mask > 0) but not
    in N4's fit (img > 0), in both facades."""
    _, ph = study
    hp = ph.hp.copy()
    masked = np.argwhere(ph.mask > 0)
    pick = masked[np.random.default_rng(3).choice(len(masked), 40,
                                                  replace=False)]
    hp[tuple(pick[:20].T)] = 0.0
    hp[tuple(pick[20:].T)] = -5.0
    jv = JaxVent(xenon_array=hp, mask_array=ph.mask)
    tv = Vent_Analysis(xenon_array=hp, mask_array=ph.mask, device="cpu")
    for v in (jv, tv):
        v.vox = VOX
        v.calculate_VDP()
    assert np.array_equal(tv.defectArrayKM, jv.defectArrayKM)
    assert np.array_equal(tv.defectArray, jv.defectArray)
    assert abs(tv.metadata["VDP_km"] - jv.metadata["VDP_km"]) <= 0.1


def test_n4_standalone_pads_the_whole_volume(pair):
    """N4_bias_correction passes no mask pad (its pad is the volume);
    calculate_VDP passes config.n4_mask_pad, which exceeds this volume, so
    both run the same N4."""
    _, tv = pair
    got = tv.N4_bias_correction(tv.HPvent, tv.mask)
    assert got.dtype == np.float32
    assert np.array_equal(got, tv.N4HPvent)


def test_pane_images_match_ventjax(study, pair):
    paths, _ = study
    fresh_j = JaxVent(xenon_path=paths["xenon_path"],
                      mask_path=paths["mask_path"])
    fresh_t = Vent_Analysis(xenon_path=paths["xenon_path"],
                            mask_path=paths["mask_path"], device="cpu")
    before_j, before_t = fresh_j.pane_images(), fresh_t.pane_images()
    assert before_t.keys() == before_j.keys()
    for key in before_j:
        assert np.array_equal(before_t[key], before_j[key]), key
    assert before_t["n4"].shape == (3, 3, 3)    # not computed yet
    jv, tv = pair
    after_j, after_t = jv.pane_images(), tv.pane_images()
    for key in ("twix", "proton", "raw"):
        assert np.array_equal(after_t[key], after_j[key]), key
    for key in ("n4", "defect", "ci"):
        assert after_t[key].shape == after_j[key].shape
        assert np.abs(after_t[key] - after_j[key]).max() <= 255 * 2e-3, key
    red = tv.array3D_to_montage2D(tv.defectArray) > 0
    assert np.all(after_t["defect"][red, 1] == 0)
    assert np.array_equal(after_t["defect"][..., 1] == 0,
                          after_j["defect"][..., 1] == 0)


def test_edit_mask_matches_ventjax(study):
    paths, _ = study
    recipe = "close:1,fillholes,erode:1"
    jv = JaxVent(xenon_path=paths["xenon_path"], mask_path=paths["mask_path"])
    tv = Vent_Analysis(xenon_path=paths["xenon_path"],
                       mask_path=paths["mask_path"], device="cpu")
    got = tv.editMask(recipe)
    want = jv.editMask(recipe)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tv.mask_border, jv.mask_border)
    assert tv.metadata["LungVolume"] == jv.metadata["LungVolume"]
    arr = Vent_Analysis(xenon_array=np.zeros((8, 8, 2)),
                        mask_array=np.ones((8, 8, 2)), device="cpu")
    assert arr.editMask("erode:1").shape == (8, 8, 2)
    assert arr.metadata["LungVolume"] == ""       # vox unset: untouched
    with pytest.raises(ValueError, match="unknown mask-edit op"):
        arr.editMask("sharpen")


def test_snr_quirk_and_manual_noise(pair):
    jv, tv = pair
    a = tv.HPvent
    assert tv.calculate_SNR(a, tv.mask) == tv.calculate_SNR(a)
    assert tv.calculate_SNR(a) == pytest.approx(jv.calculate_SNR(a),
                                                rel=1e-4)
    with pytest.raises(NotImplementedError, match="manualNoise"):
        tv.calculate_SNR(a, manualNoise=True)


def test_extract_attributes_matches_ventjax(pair):
    _, tv = pair
    d = {"a": 1, "b": {"c": 2, "d": {"e": 3}}, "metadata": tv.metadata}
    assert extract_attributes(d) == jax_extract(d)
    assert extract_attributes(d, sep=".")["b.d.e"] == 3


def test_process_raw_matches_ventjax(tmp_path):
    rng = np.random.default_rng(8)
    k = (rng.normal(size=(16, 12, 2))
         + 1j * rng.normal(size=(16, 12, 2))).astype(np.complex64)
    p = str(tmp_path / "m.dat")
    write_synthetic_twix(p, k, protocol_name="vent_gre")
    out = []
    for v in (JaxVent(xenon_array=np.zeros((4, 4, 2)),
                      mask_array=np.ones((4, 4, 2))),
              Vent_Analysis(xenon_array=np.zeros((4, 4, 2)),
                            mask_array=np.ones((4, 4, 2)), device="cpu")):
        out.append((v.process_RAW(p), v))
    (want, jv), (got, tv) = out
    assert got.dtype == want.dtype and got.shape == want.shape == (12, 16, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert tv.metadata == jv.metadata
    assert tv.metadata["TWIXprotocolName"] == "vent_gre"
    assert np.array_equal(tv.raw_K, jv.raw_K)


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    from ventjax_torch.ops.fft_recon import recon_2d_multislice

    with pytest.raises(RuntimeError, match="no CUDA card"):
        Vent_Analysis(xenon_array=np.zeros((4, 4, 2)),
                      mask_array=np.ones((4, 4, 2)))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ci_module.calculate_CI(np.ones((8, 8, 2)), vox=VOX)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        recon_2d_multislice(np.ones((4, 4, 2), np.complex64))


def test_ventjax_pickle_loads_without_ventjax(pair, tmp_path):
    """A pickle written by ventjax's facade (classes under ventjax.*) loads
    in the port, in a process where no ventjax or jax module is ever
    imported, and restores the study."""
    jv, _ = pair
    path = jv.pickleMe(str(tmp_path / "jax.pkl"))
    code = (
        "import sys\n"
        "from ventjax_torch.compat import Vent_Analysis\n"
        f"v = Vent_Analysis(pickle_path={path!r}, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ventjax', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print(type(v.config).__module__, type(v.ds).__module__, "
        "v.metadata['VDP'], int(v.defectArray.sum()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    cfg_mod, ds_mod, vdp, n_def = out.stdout.split()
    assert (cfg_mod, ds_mod) == ("ventjax_torch.config",
                                 "ventjax_torch.io.dicom")
    assert float(vdp) == jv.metadata["VDP"]
    assert int(n_def) == int(jv.defectArray.sum())


def test_artifacts_cross_load_between_packages(pair, tmp_path):
    """Pickles and NPZs written by either facade load in the other with
    the same metrics and arrays."""
    jv, tv = pair
    for writer, reader in ((jv, Vent_Analysis), (tv, JaxVent)):
        kw = {"device": "cpu"} if reader is Vent_Analysis else {}
        tag = type(writer).__module__.split(".")[0]
        for key, fn in (("pickle_path", writer.pickleMe),
                        ("npz_path", writer.saveNpz)):
            path = fn(str(tmp_path / f"{tag}_{key}.bin"))
            back = reader(**{key: path}, **kw)
            for m in METRICS:
                assert float(back.metadata[m]) == float(writer.metadata[m])
            assert np.array_equal(back.defectArray, writer.defectArray)
            assert dataclasses.asdict(back.config) == \
                dataclasses.asdict(writer.config)


def test_foreign_pickle_raises_in_port(tmp_path):
    """A name of ventjax that the port has no copy of is reported, not
    imported; strip_foreign keeps the rest."""
    p = tmp_path / "odd.pkl"
    # protocol 0 text: GLOBAL 'ventjax.ops.n4 n4_field_from_phi_np' (the
    # compact pack's host field, not ported by decision; every ventjax
    # class now has a copy), then a dict holding that name and an array
    state = {"mask": np.ones(3), "model": "PLACEHOLDER"}
    raw = pickle.dumps(state, protocol=0)
    raw = raw.replace(b"VPLACEHOLDER",
                      b"cventjax.ops.n4\nn4_field_from_phi_np")
    p.write_bytes(raw)
    with pytest.raises(texport.ReferencePickleError,
                       match="n4_field_from_phi_np"):
        texport.load_pickle(str(p))
    got = texport.load_pickle(str(p), strip_foreign=True)
    assert np.array_equal(got["mask"], np.ones(3))
    assert got["model"]._foreign_class == \
        "ventjax.ops.n4.n4_field_from_phi_np"
    # classes the port now has copies of load as those copies
    from ventjax_torch.gui.controller import VentController
    from ventjax_torch.models.segmentation import SegUNet

    for ref, cls in ((b"cventjax.models.segmentation\nSegUNet", SegUNet),
                     (b"cventjax.gui.controller\nVentController",
                      VentController)):
        p.write_bytes(pickle.dumps(state, protocol=0).replace(
            b"VPLACEHOLDER", ref))
        assert texport.load_pickle(str(p))["model"] is cls


# --------------------------------------------------------------- ci_module

def test_ci_module_helpers_bit_equal():
    defect = np.zeros((24, 20, 4))
    defect[4:9, 5:10, 1:3] = 1
    assert np.array_equal(ci_module.multi_which(defect),
                          jci.multi_which(defect))
    assert np.array_equal(ci_module.multi_which(3), jci.multi_which(3))
    shape = (10, 10, 4)
    for ijk in ((2, 3, 4), (0, 0, 0), (9, 9, 3)):
        n = ci_module.px2vec(*ijk, shape)
        assert n == jci.px2vec(*ijk, shape)
        assert ci_module.vec2px(n, shape) == jci.vec2px(n, shape)
    for vox, r in (([1.5, 1.5, 10.0], 50), ([3.125, 3.125, 15.0], 20),
                   ([1.0, 2.0, 3.0], 12)):
        px = ci_module.getSpherePix(np.asarray(vox), r)
        assert np.array_equal(px, jci.getSpherePix(np.asarray(vox), r))
        assert np.array_equal(ci_module.getRadiiIndices(px),
                              jci.getRadiiIndices(px))
    assert ci_module.getSpherePix(np.asarray(VOX), 50).shape == (78659, 4)


def test_calculate_cv_matches_ventjax_and_the_map():
    defect = np.zeros((24, 20, 4))
    defect[4:9, 5:10, 1:3] = 1
    defect[15:18, 2:5, 0] = 1       # a second cluster on a border
    sphere_px = ci_module.getSpherePix(np.asarray(VOX), 50)
    def_list = ci_module.multi_which(defect)
    def_vec = ci_module.px2vec(def_list[:, 0], def_list[:, 1],
                               def_list[:, 2], defect.shape)
    built = np.zeros_like(defect)
    for row in def_list:
        cv = ci_module.calculate_CV(defect.shape, row, def_vec, sphere_px)
        assert np.array_equal(cv, jci.calculate_CV(defect.shape, row,
                                                   def_vec, sphere_px))
        built[tuple(row)] = cv[3] * np.min(VOX)
    got = ci_module.calculate_CI(defect, vox=VOX, Rmax=50, device="cpu")
    assert np.abs(built - got).max() < 2e-5
    solid = (120, 120, 20)
    slist = np.argwhere(np.ones(solid))
    svec = ci_module.px2vec(slist[:, 0], slist[:, 1], slist[:, 2], solid)
    with pytest.raises(ValueError, match="Rmax"):
        ci_module.calculate_CV(solid, np.array([60, 60, 10]), svec,
                               sphere_px)


@pytest.mark.parametrize("vox,rmax,shape", [
    ([1.5, 1.5, 10.0], 50, (24, 20, 4)),     # pairwise engine (K3)
    ([3.125, 3.125, 15.0], 20, (32, 32, 6)),  # the gather ladder
])
def test_calculate_ci_matches_ventjax_and_oracle(vox, rmax, shape):
    rng = np.random.default_rng(11)
    defect = (rng.random(shape) > 0.93).astype(np.float64)
    defect[4:10, 5:11, 1:3] = 1
    got = ci_module.calculate_CI(defect, vox=vox, Rmax=rmax, device="cpu")
    want = jci.calculate_CI(defect, vox=vox, Rmax=rmax)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 2e-5
    oracle = calculate_ci_oracle(defect, vox=vox, rmax=rmax, saturate=True)
    assert np.abs(got - oracle).max() <= 2e-5


def test_calculate_ci_tail_retry_is_exact(monkeypatch):
    """A dense single cluster overflows the pairwise engine's default tail
    budget; the one retry at tail_k = pad gives the oracle's map."""
    defect = np.zeros((24, 24, 6))
    defect[2:22, 2:22, 2:4] = 1
    calls = []
    real = ci_module.calculate_ci_pairwise

    def spy(d, geom, max_defect_voxels, tail_k=None, **kw):
        calls.append(tail_k)
        return real(d, geom, max_defect_voxels=max_defect_voxels,
                    tail_k=tail_k, **kw)

    monkeypatch.setattr(ci_module, "calculate_ci_pairwise", spy)
    got = ci_module.calculate_CI(defect, vox=VOX, Rmax=50, device="cpu")
    assert calls == [None, 1024]
    oracle = calculate_ci_oracle(defect, vox=VOX, rmax=50, saturate=True)
    assert np.abs(got - oracle).max() <= 2e-5


@pytest.mark.parametrize("n_def,pad", [(0, 256), (1, 256), (256, 256),
                                       (257, 512), (4055, 4096)])
def test_defect_pad(n_def, pad):
    """The CI pad: the smallest power of two >= 256 holding every defect."""
    defect = np.zeros(64 * 64 * 2)
    defect[:n_def] = 1
    assert ci_module.defect_pad(defect.reshape(64, 64, 2)) == pad


def test_ci_shard_slices_is_refused():
    """More shards than the device's local devices (the CPU is one): the
    refusal of ventjax's calculate_ci_sharded, before any work."""
    cfg = DEFAULT_CONFIG.replace(ci_shard_slices=2)
    with pytest.raises(ValueError, match=r"--shard-slices 2 exceeds the 1 "
                       r"visible device\(s\); use at most 1 shards"):
        ci_module.calculate_CI(np.ones((8, 8, 2)), vox=VOX, config=cfg,
                               device="cpu")


def test_ci_shard_slices_branch_equals_one_device(study, pair, monkeypatch):
    """The facade's calculate_CI with ci_shard_slices 2 over two CPU shards
    (the port's device list replaced): the one-device CI map and subject CI
    at the same rmax (16: a 3-slice halo fits the 4-slice shards), and
    ventjax's sharded map."""
    from ventjax_torch.dist import mesh

    paths, _ = study
    _, tv = pair
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)
    maps = {}
    for n in (0, 2):
        v = Vent_Analysis(**paths, device="cpu", config=DEFAULT_CONFIG.replace(
            ci_rmax=16, ci_shard_slices=n))
        v.defectArray = tv.defectArray
        maps[n] = (v.calculate_CI(), v.metadata["CI"])
    assert tv.defectArray.sum() > 0
    np.testing.assert_array_equal(maps[2][0], maps[0][0])
    assert maps[2][1] == maps[0][1]
    want = jci.calculate_CI(
        tv.defectArray, vox=VOX, Rmax=16,
        config=JAX_DEFAULT_CONFIG.replace(ci_shard_slices=2))
    np.testing.assert_array_equal(maps[2][0], want)


# --------------------------------------------------------------------- CLI

def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _analyze_argv(paths, out):
    return ["analyze", "--xenon", paths["xenon_path"], "--mask",
            paths["mask_path"], "--proton", paths["proton_path"], "--out",
            out, "--npz", "--histogram", "--irb", "mepo", "--id", "0039",
            "--visit", "1", "--treatment", "preAlb", "--user", "RPT"]


@pytest.fixture(scope="module")
def cli_runs(study, tmp_path_factory):
    paths, _ = study
    root = tmp_path_factory.mktemp("cli_runs")
    jout, tout = str(root / "jax"), str(root / "torch")
    rj = _run(jax_main, ["--no-compile-cache"] + _analyze_argv(paths, jout))
    rt = _run(main, _analyze_argv(paths, tout) + ["--device", "cpu"])
    return rj, rt, jout, tout


def _check_summary(want, got):
    assert set(got) == set(want)
    for key in want:
        if key in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(got[key] - want[key]) <= 0.1, key
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-4), key


def test_cli_analyze_matches_ventjax(cli_runs):
    (rcj, oj, _), (rct, ot, _), jout, tout = cli_runs
    assert rcj == rct == 0
    _check_summary(json.loads(oj), json.loads(ot))
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    name = [f for f in os.listdir(tout) if f.endswith(".pkl")][0]
    assert name.startswith("Mepo0039_") and "_visit1_preAlb" in name
    assert len(os.listdir(os.path.join(tout, "defectDICOMS"))) == 8
    # each package reads the other's pickle
    tstate = jexport.load_pickle(os.path.join(tout, name))
    jstate = texport.load_pickle(os.path.join(jout, name))
    _check_metadata(jstate["metadata"], tstate["metadata"])
    assert tstate["metadata"]["mepo_id"] == "0039"


def test_cli_export_matches_ventjax(cli_runs, tmp_path):
    _, _, jout, tout = cli_runs
    stem = [f for f in os.listdir(tout) if f.endswith(".npz")][0][:-4]
    res = {}
    for fn, src, extra in ((jax_main, jout, ["--no-compile-cache"]),
                           (main, tout, [])):
        out = str(tmp_path / fn.__module__.split(".")[0])
        argv = extra + ["export", "--npz-in", f"{src}/{stem}.npz", "--out",
                        out, "--recalculate", "--histogram"]
        if fn is main:
            argv += ["--device", "cpu"]
        rc, o, _ = _run(fn, argv)
        assert rc == 0
        res[fn is main] = json.loads(o)
    want, got = res[False], res[True]
    assert [os.path.basename(p) for p in got["written"]] == \
        [os.path.basename(p) for p in want["written"]]
    assert got["skipped"] == want["skipped"]
    _check_summary(want["metrics"], got["metrics"])
    # the port exports a ventjax-written pickle, DICOM header included,
    # with the metrics ventjax stored
    rc, o, _ = _run(main, ["export", "--pickle", f"{jout}/{stem}.pkl",
                           "--out", str(tmp_path / "from_jax"),
                           "--device", "cpu"])
    assert rc == 0
    report = json.loads(o)
    assert report["skipped"] == []
    assert report["metrics"] == json.loads(cli_runs[0][1])
    assert any(p.endswith("defectDICOMS") for p in report["written"])


def test_cli_export_errors_exit_2(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    rc, _, err = _run(main, ["export", "--npz-in", str(bad), "--out",
                             str(tmp_path / "o"), "--device", "cpu"])
    assert rc == 2 and "not an NPZ" in err
    empty = texport.save_npz({"metadata": {}}, str(tmp_path / "e.npz"))
    rc, _, err = _run(main, ["export", "--npz-in", empty, "--out",
                             str(tmp_path / "o"), "--device", "cpu"])
    assert rc == 2 and "nothing to export" in err


@pytest.mark.parametrize("coils", [1, 3])
def test_cli_twix_matches_ventjax(coils, tmp_path):
    rng = np.random.default_rng(coils)
    shape = ((coils,) if coils > 1 else ()) + (16, 12, 3)
    k = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    dat = str(tmp_path / "m.dat")
    write_synthetic_twix(dat, k)
    rc, oj, _ = _run(jax_main, ["--no-compile-cache", "twix", "--dat", dat,
                                "--out", str(tmp_path / "j")])
    rct, ot, _ = _run(main, ["twix", "--dat", dat, "--out",
                             str(tmp_path / "t"), "--device", "cpu"])
    assert rc == rct == 0
    want, got = json.loads(oj), json.loads(ot)
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    a, b = np.load(want["out"]), np.load(got["out"])
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_cli_commands_without_a_card_exit_2(study, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    paths, _ = study
    out = tmp_path / "out"
    for argv in (_analyze_argv(paths, str(out)),
                 ["export", "--npz-in", "x.npz", "--out", str(out)],
                 ["twix", "--dat", "x.dat", "--out", str(out)]):
        rc, _, err = _run(main, argv)
        assert rc == 2 and "no CUDA card" in err, argv
    assert not out.exists()


def test_cli_analyze_without_pillow_exits_2(study, tmp_path, monkeypatch):
    paths, _ = study
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tmp_path / "out"
    rc, _, err = _run(main, _analyze_argv(paths, str(out))
                      + ["--device", "cpu"])
    assert rc == 2 and "Pillow" in err
    assert not out.exists()
