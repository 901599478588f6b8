"""ventjax_torch's cohort driver (pipeline/cohort.py) and grouped analysis
against ventjax's, on synthetic DICOM studies.

Tolerances: the metrics of the two drivers within |dVDP| < 0.1 percentage
points for the three VDPs (the two N4s differ within the bf16-fit
envelope), lung volume and the flags exact; the defect channel of the
NIfTI exports equal; the CI channel within 2e-5 mm (float32 radii) where
the defect channels agree.  The retry-ladder cases are ventjax's
(tests/test_cohort_retry.py) that need no device mesh, at smaller volumes
and a short N4.
"""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.io.nifti import load as nifti_load
from ventjax.io.phantom import make_cohort, make_phantom
from ventjax.io.synthetic import write_study
from ventjax.pipeline.cohort import run_cohort as jax_run_cohort
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.ops.ci import CIGeometry
from ventjax_torch.pipeline import (
    analyze_cohort, analyze_cohort_grouped, build_geometry, make_analyze_fn,
)
from ventjax_torch.pipeline import cohort as tc

torch.set_num_threads(2)

SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)
LADDER_VOX = (3.125, 3.125, 15.0)   # fails the pairwise proof at rmax 16
FAST_KW = dict(ci_max_defect_voxels=512, ci_rmax=16, n4_fitting_levels=2,
               n4_max_iters=5)
FAST = DEFAULT_CONFIG.replace(**FAST_KW)


def _entry(root, sid):
    return {"id": sid, "xenon": f"{root}/xenon.dcm", "mask": f"{root}/mask"}


def _write(tmp_path, sid, **kw):
    root = str(tmp_path / sid)
    write_study(root, **kw)
    return _entry(root, sid)


def _js(records):
    """Metrics records as JSON text (NaN-aware equality, order-free)."""
    if isinstance(records, dict):
        return json.dumps(records, sort_keys=True)
    return sorted(_js(r) for r in records)


def _nifti(out, sid):
    return nifti_load(os.path.join(out, sid, f"{sid}_dataArray.nii"))[0]


def _big_defect_phantom(seed):
    """More defect voxels than the driver's first 512-voxel CI bucket."""
    ph = make_phantom(shape=SHAPE, vox=VOX, seed=seed, n_defects=6,
                      defect_radius_vox=(6.0, 8.0, 10.0))
    assert ph.true_defect.sum() > 512
    return ph


@pytest.fixture(scope="module")
def two_geometries(tmp_path_factory):
    """The two-geometry manifest of tests/test_pipeline.py (a pairwise and
    a ladder geometry) plus an entry that does not decode, through both
    drivers."""
    tmp = tmp_path_factory.mktemp("cohort")
    assert not isinstance(build_geometry(VOX, SHAPE, FAST), CIGeometry)
    assert isinstance(build_geometry(LADDER_VOX, SHAPE, FAST), CIGeometry)
    manifest = [_write(tmp, f"s{i}", shape=SHAPE, vox=vox, seed=40 + i,
                       with_proton=False)
                for i, vox in enumerate((VOX, LADDER_VOX))]
    manifest.append(_entry(str(tmp / "missing"), "broken"))
    events = []
    port = tc.run_cohort(manifest, str(tmp / "port"), config=FAST,
                         progress=lambda *a: events.append(a), device="cpu")
    ref = jax_run_cohort(manifest[:2], str(tmp / "ref"),
                         config=JAX_DEFAULT_CONFIG.replace(**FAST_KW),
                         use_mesh=False, compact_export=False)
    return tmp, manifest, port, ref, events


def test_run_cohort_matches_ventjax(two_geometries):
    tmp, _, port, ref, _ = two_geometries
    port = {r["id"]: r for r in port}
    for want in ref:
        sid = want["id"]
        got = port[sid]
        assert set(got) == set(want)
        for k in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(got[k] - want[k]) < 0.1, (sid, k)
        for k in ("LungVolume", "valid", "CI_overflow", "N4_overflow"):
            assert got[k] == want[k], (sid, k)
        assert got["valid"] and not got["CI_overflow"]
        a, b = _nifti(str(tmp / "port"), sid), _nifti(str(tmp / "ref"), sid)
        # channels: 0 proton, 1 hp, 2 mask, 3 n4, 4 defect, 5 ci
        for ch in (0, 1, 2, 4):
            np.testing.assert_array_equal(a[..., ch], b[..., ch])
        assert np.abs(a[..., 5] - b[..., 5]).max() < 2e-5
        assert a[..., 4].sum() > 0


def test_run_cohort_exports_and_decode_failed(two_geometries):
    tmp, _, port, _, events = two_geometries
    by_id = {r["id"]: r for r in port}
    assert by_id["broken"] == {"id": "broken", "valid": False,
                               "error": "decode_failed"}
    out = str(tmp / "port")
    assert not os.path.exists(os.path.join(out, "broken", ".done"))
    assert _js(json.load(open(os.path.join(out, "broken", "metrics.json")))) \
        == _js(by_id["broken"])
    for sid in ("s0", "s1"):
        names = set(os.listdir(os.path.join(out, sid)))
        assert {".done", "metrics.json", f"{sid}.json",
                f"{sid}_dataArray.nii"} <= names
        assert _js(json.load(open(os.path.join(out, sid, "metrics.json")))) \
            == _js(by_id[sid])
    stages = {e[0] for e in events}
    assert stages == {"decode", "analyze", "export"}
    assert max(e[1] for e in events if e[0] == "export") == 2


def test_run_cohort_resumes_from_markers(two_geometries, monkeypatch):
    tmp, manifest, port, _, _ = two_geometries
    out = str(tmp / "port")

    def no_analysis(*a, **k):
        raise AssertionError("a resumed subject was analysed again")

    monkeypatch.setattr(tc, "analyze_cohort", no_analysis)
    again = tc.run_cohort(manifest[:2], out, config=FAST, device="cpu")
    assert _js(again) == _js([r for r in port if r["id"] != "broken"])
    monkeypatch.undo()
    os.remove(os.path.join(out, "s0", ".done"))
    redo = tc.run_cohort(manifest[:2], out, config=FAST, device="cpu")
    assert len(redo) == 2 and os.path.exists(os.path.join(out, "s0", ".done"))
    assert _js(redo) == _js([r for r in port if r["id"] != "broken"])


def test_resume_with_missing_metrics_answers_as_ventjax(two_geometries,
                                                      tmp_path):
    """A done study whose metrics.json is gone resumes as
    {"id": ..., "resumed": True} in both drivers, and nothing raises."""
    tmp, manifest, port, _, _ = two_geometries
    answers = {}
    for tag in ("port", "ref"):
        out = str(tmp_path / tag)
        shutil.copytree(str(tmp / tag), out)
        os.remove(os.path.join(out, "s0", "metrics.json"))
        if tag == "port":
            answers[tag] = tc.run_cohort(manifest[:2], out, config=FAST,
                                         device="cpu")
        else:
            answers[tag] = jax_run_cohort(
                manifest[:2], out, config=JAX_DEFAULT_CONFIG.replace(**FAST_KW),
                use_mesh=False, compact_export=False)
    assert answers["port"][0] == answers["ref"][0] == {"id": "s0",
                                                       "resumed": True}
    assert _js(answers["port"][1]) == _js(
        next(r for r in port if r["id"] == "s1"))
    assert answers["ref"][1]["id"] == "s1"


def test_cohort_mixed_transfer_syntaxes_matches_ventjax(tmp_path):
    """The mixed-syntax cohort of tests/test_io_jpeg.py (one study as plain
    Explicit VR LE, with an RLE Lossless mask, and as JPEG 2000 lossless)
    gives the same metrics for all three encodings, and ventjax's."""
    pytest.importorskip("PIL")
    from test_io_jpeg import j2k_encode, write_encap_file
    from test_io_rle import write_rle_file

    from ventjax.io import dicom as jdcm
    from ventjax.io.synthetic import write_mask_folder, write_multiframe

    ph = make_phantom(shape=SHAPE, vox=VOX, seed=6)
    H, W, D = SHAPE
    frames16 = np.clip(
        np.transpose(ph.hp, (2, 0, 1)), 0, 65535).astype(np.uint16)
    mask16 = (np.asarray(ph.mask) > 0).astype(np.uint16)
    a, b, c = (tmp_path / "a", tmp_path / "b" / "mask", tmp_path / "c" / "mask")
    for d in (a, b, c):
        d.mkdir(parents=True)
    write_multiframe(str(a / "xenon.dcm"), ph.hp, ph.vox)
    write_mask_folder(str(a / "mask"), ph.mask, ph.vox)
    for k in range(D):
        write_rle_file(str(b / f"s{k:03d}.dcm"), mask16[None, :, :, k].copy())
        write_encap_file(str(c / f"s{k:03d}.dcm"), jdcm.JPEG2000_LOSSLESS,
                         [j2k_encode(mask16[:, :, k].copy())],
                         rows=H, cols=W, nframes=1, bits=16)
    write_encap_file(str(c.parent / "xenon.dcm"), jdcm.JPEG2000_LOSSLESS,
                     [j2k_encode(f.copy()) for f in frames16],
                     rows=H, cols=W, nframes=D, bits=16,
                     extra={"SpacingBetweenSlices": VOX[2],
                            "PixelSpacing": jdcm.MultiValue(list(VOX[:2])),
                            "SliceThickness": VOX[2]})
    manifest = [
        {"id": "plain", "xenon": str(a / "xenon.dcm"), "mask": str(a / "mask")},
        {"id": "rle", "xenon": str(a / "xenon.dcm"), "mask": str(b)},
        {"id": "j2k", "xenon": str(c.parent / "xenon.dcm"), "mask": str(c)},
    ]
    port = {r["id"]: r for r in tc.run_cohort(
        manifest, str(tmp_path / "port"), config=FAST, batch_size=2,
        device="cpu")}
    ref = {r["id"]: r for r in jax_run_cohort(
        manifest, str(tmp_path / "ref"),
        config=JAX_DEFAULT_CONFIG.replace(**FAST_KW), batch_size=2,
        use_mesh=False, compact_export=False)}
    assert set(port) == set(ref) == {"plain", "rle", "j2k"}
    for sid, want in ref.items():
        got = port[sid]
        assert "error" not in got and got["valid"], (sid, got)
        assert set(got) == set(want)
        for k in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(got[k] - want[k]) < 0.1, (sid, k)
        for k in ("LungVolume", "valid", "CI_overflow", "N4_overflow"):
            assert got[k] == want[k], (sid, k)
    for key in ("VDP", "VDP_lb", "SNR", "CI", "LungVolume"):
        vals = [port[i][key] for i in ("plain", "rle", "j2k")]
        np.testing.assert_array_equal(vals[1:], vals[:2], key)  # NaN-aware
    np.testing.assert_array_equal(port["j2k"]["SNR"], ref["j2k"]["SNR"])


def test_retry_on_overflow_matches_direct_run(tmp_path):
    """The first dispatch overflows the 512-voxel CI bucket; the batch is
    retried at a grown pad and exports clean metrics equal to a direct
    analyze_cohort at a roomy pad."""
    phs = [_big_defect_phantom(20 + i) for i in range(2)]
    manifest = [_write(tmp_path, f"s{i}", phantom=ph)
                for i, ph in enumerate(phs)]
    cfg = FAST.replace(ci_max_defect_voxels=8192)
    runners = {}
    res = {r["id"]: r for r in tc.run_cohort(
        manifest, str(tmp_path / "out"), config=cfg, batch_size=2,
        runners=runners, device="cpu")}
    runner = next(iter(runners.values()))
    assert runner.ci_bucket > 512
    direct_cfg = cfg.replace(ci_max_defect_voxels=runner.ci_bucket,
                             n4_mask_pad=runner.n4_bucket)
    direct = analyze_cohort(
        torch.from_numpy(np.stack([ph.hp for ph in phs])),
        torch.from_numpy(np.stack([ph.mask for ph in phs])),
        build_geometry(VOX, SHAPE, direct_cfg), direct_cfg)
    for i in range(2):
        r = res[f"s{i}"]
        assert r["valid"] and not r["CI_overflow"] and not r["N4_overflow"]
        assert r["VDP"] == float(direct.metrics.vdp[i])
        assert r["CI"] == float(direct.metrics.ci[i])
        assert os.path.exists(tmp_path / "out" / f"s{i}" / ".done")
        np.testing.assert_array_equal(
            _nifti(str(tmp_path / "out"), f"s{i}")[..., 5],
            direct.ci_map[i].numpy())


def test_overflow_flag_stands_at_ceiling_with_complete_defects(tmp_path):
    """A ceiling below the defect count: no endless retry, the flag stands,
    and the exported defect channel is complete (the pack is dense)."""
    ph = _big_defect_phantom(40)
    cfg = FAST.replace(ci_max_defect_voxels=256)
    res = tc.run_cohort([_write(tmp_path, "s", phantom=ph)],
                        str(tmp_path / "out"), config=cfg, batch_size=1,
                        device="cpu")
    m = res[0]
    assert m["valid"] and m["CI_overflow"]
    assert json.load(open(tmp_path / "out" / "s" / "metrics.json"))[
        "CI_overflow"]
    data = _nifti(str(tmp_path / "out"), "s")
    n_exported = int((data[..., 4] > 0).sum())
    vox_cc = float(np.prod(VOX)) / 1000.0
    assert n_exported == int(round(m["DefectVolume"] * 1000.0 / vox_cc))
    assert n_exported > 256
    assert int((data[..., 5] > 0).sum()) <= 256   # the flagged first K


@pytest.mark.parametrize("vox,pairwise", [(VOX, True), (LADDER_VOX, False)])
def test_bump_policy(vox, pairwise):
    """Pad doubling to the ceiling, then one full-width tail retry for the
    pairwise engine only (the ladder has no tail budget), then the flag
    stands; N4 growth is independent."""
    cfg = FAST.replace(ci_max_defect_voxels=1024)
    r = tc._GeometryRunner((64, 64, 8), vox, cfg, 1, device="cpu")
    assert r.ci_bucket == 512 and not r.ci_tail_full
    assert r.bump_for_retry(True, False, (512, 8192, False))
    assert r.ci_bucket == 1024 and not r.ci_tail_full
    assert r.bump_for_retry(True, False, (1024, 8192, False)) == pairwise
    assert r.ci_tail_full == pairwise
    assert not r.bump_for_retry(True, False, (1024, 8192, pairwise))
    assert r.bump_for_retry(False, True, (1024, 8192, pairwise))
    assert r.n4_bucket == 16384
    # a second worker reporting the same overflow retries without a second
    # bump
    assert r.bump_for_retry(False, True, (1024, 8192, pairwise))
    assert r.n4_bucket == 16384


def test_adaptive_pad_sizes():
    """adaptive_pad pads a partial batch to the next power of two (at most
    the batch size); the default pads to the batch size."""
    fixed = tc._GeometryRunner(SHAPE, VOX, FAST, 8, device="cpu")
    adaptive = tc._GeometryRunner(SHAPE, VOX, FAST, 8, adaptive_pad=True,
                                  device="cpu")
    assert [fixed._eff_bs(n) for n in (1, 3, 8)] == [8, 8, 8]
    assert [adaptive._eff_bs(n) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]
    hp, mask, _ = make_cohort(1, SHAPE, VOX, seed=3)
    pack, _ = adaptive.dispatch([({"id": "a"},
                                  (hp[0], mask[0], VOX, None, None))])
    assert pack["n4_cv"].shape[0] == 1     # the compact pack's N4 leaf


def test_tail_escalation_clears_dense_cluster_overflow():
    """A dense cluster overflows the pairwise CI tail even at the pad
    ceiling; the full-width tail retry clears the flag and gives
    unsaturated CI values."""
    vox = VOX
    cfg = FAST.replace(ci_max_defect_voxels=2048)
    hp = np.zeros(SHAPE, np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[2:30, 2:30, :] = 1.0
    hp[mask > 0] = 400.0
    hp[8:24, 8:24, 1:7] = 4.0        # a deep 16x16x6 defect cluster
    runner = tc._GeometryRunner(SHAPE, vox, cfg, 1, device="cpu")
    runner.ci_bucket = 2048          # straight to the ceiling
    batch = [({"id": "t"}, (hp, mask, vox, None, None))]
    for attempt in range(3):
        pack, pads = runner.dispatch(batch)
        ovf = bool(tc._metrics_from_vec(pack["mvec"].numpy()).ci_overflow[0])
        if not ovf:
            break
        assert runner.bump_for_retry(ovf, False, pads)
    assert attempt == 1 and runner.ci_tail_full
    n = int(pack["n_def"][0])
    assert n > 2048 // 8
    # no voxel kept the saturated sentinel (the last ball's radius)
    assert int(tc._metrics_from_vec(pack["mvec"].numpy()).ci_saturated[0]) \
        == 0
    last = float(build_geometry(vox, SHAPE, cfg).radii32[-1]) * min(vox)
    assert float(pack["ci_cv"][0][:n].max()) < last


def test_invalid_lane_does_not_drive_escalation(tmp_path):
    """An empty-mask subject always flags CI overflow (it runs on a
    stand-in mask); only valid lanes drive the retry ladder."""
    ok = make_phantom(shape=SHAPE, vox=VOX, seed=61)
    bad = make_phantom(shape=SHAPE, vox=VOX, seed=62)
    bad.mask[...] = 0.0
    manifest = [_write(tmp_path, sid, phantom=ph)
                for sid, ph in (("ok", ok), ("bad", bad))]
    runners = {}
    res = {r["id"]: r for r in tc.run_cohort(
        manifest, str(tmp_path / "out"), config=FAST.replace(ci_rmax=12),
        batch_size=2, runners=runners, device="cpu")}
    assert res["ok"]["valid"] and not res["bad"]["valid"]
    assert res["bad"]["CI_overflow"]
    runner = next(iter(runners.values()))
    assert runner.ci_bucket == 512 and not runner.ci_tail_full


def test_dispatch_reads_bucket_state_under_lock():
    """Every read of the sticky state in dispatch happens under
    _bucket_lock, so the pads it runs with are one snapshot."""
    runner = tc._GeometryRunner(SHAPE, VOX, FAST, 1, device="cpu")
    lock = runner._bucket_lock
    unlocked = []

    class Watched(tc._GeometryRunner):
        def __getattribute__(self, name):
            if name in ("ci_bucket", "n4_bucket", "ci_tail_full"):
                if not lock.locked():
                    unlocked.append(name)
            return object.__getattribute__(self, name)

    runner.__class__ = Watched
    hp, mask, _ = make_cohort(1, SHAPE, VOX, seed=3)
    pack, pads = runner.dispatch([({"id": "a"},
                                   (hp[0], mask[0], VOX, None, None))])
    assert pads == (512, 8192, False)
    assert unlocked == []
    assert isinstance(lock, type(threading.Lock()))


def test_decode_subject_narrows_and_densify_truncates(tmp_path):
    e = _write(tmp_path, "s", shape=(32, 32, 4), vox=VOX, seed=1,
               with_proton=False)
    hp, mask, vox, ds, proton = tc._decode_subject(e)
    assert hp.dtype == np.uint16 and mask.dtype == np.uint8
    assert vox == VOX and proton is None
    assert tc._decode_subject(_entry(str(tmp_path / "x"), "x"))[0] is None
    # a lane with more defect voxels than its pad rebuilds the device's
    # own first-K truncation
    defect = np.zeros((4, 4, 4), np.uint8)
    defect.reshape(-1)[:10] = 1
    cv = np.arange(1, 7, dtype=np.float32)
    ci = tc._densify_ci({"defect": defect, "ci_cv": cv, "n_def": 10})
    assert np.array_equal(ci.reshape(-1)[:6], cv)
    assert not ci.reshape(-1)[6:].any()


def test_load_manifest_validates(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps([{"id": "a", "xenon": "x", "mask": "m"}]))
    assert tc.load_manifest(str(p))[0]["id"] == "a"
    for bad in ([{"id": "a", "xenon": "x"}],
                [{"id": "a", "xenon": "x", "mask": "m"}] * 2, {"id": "a"}):
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError):
            tc.load_manifest(str(p))


def test_grouped_equals_ungrouped():
    """Four lanes as two groups of two, bit-equal to one batch of four;
    N not a multiple of the group is the plain run."""
    hp, mask, _ = make_cohort(4, SHAPE, VOX, seed=7)
    h, m = torch.from_numpy(hp), torch.from_numpy(mask)
    cfg = FAST.replace(n4_mask_pad=4096)
    geom = build_geometry(VOX, SHAPE, cfg)
    whole = analyze_cohort(h, m, geom, cfg)
    grouped = analyze_cohort_grouped(h, m, geom, cfg, group_size=2)
    for f in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
              "ci_map"):
        assert torch.equal(getattr(grouped, f), getattr(whole, f)), f
    for f in tc._METRIC_FIELDS:      # NaN-aware: the SNR of a small FOV
        np.testing.assert_array_equal(getattr(grouped.metrics, f).numpy(),
                                      getattr(whole.metrics, f).numpy(), f)
    odd = analyze_cohort_grouped(h[:3], m[:3], geom, cfg, group_size=2)
    assert torch.equal(odd.ci_map, whole.ci_map[:3])
    fn = make_analyze_fn(VOX, SHAPE, cfg, batched=True)
    assert make_analyze_fn(VOX, SHAPE, cfg, batched=True) is fn
    assert torch.equal(fn(h, m).defect, whole.defect)
    one = make_analyze_fn(VOX, SHAPE, cfg)(h[1], m[1])
    assert torch.equal(one.ci_map, whole.ci_map[1])
