"""ventjax_torch's command line (cli.py, ``python -m ventjax_torch``) and
its cohort summary (pipeline/summary.py) on the CPU (``--device cpu``).

The cohort summary is held equal to ventjax's cohort_summary on the same
results (its file, as JSON text), and on the rows of tests/test_summary.py.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from ventjax.cli import parse_geometry_spec as jax_parse_geometry_spec
from ventjax.pipeline.summary import cohort_summary as jax_cohort_summary
from ventjax_torch.cli import build_parser, main, parse_geometry_spec
from ventjax_torch.io.synthetic import write_study
from ventjax_torch.pipeline import summary as summary_mod
from ventjax_torch.pipeline.summary import cohort_summary

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def study_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_study")
    write_study(str(root), shape=(32, 32, 8), vox=(1.5, 1.5, 10.0), seed=6)
    return str(root)


def _js(x):
    return json.dumps(x, sort_keys=True)


def test_cli_cohort_summary_resume(study_root, tmp_path, capsys,
                                   monkeypatch):
    manifest = [
        {"id": "s0", "xenon": f"{study_root}/xenon.dcm",
         "mask": f"{study_root}/mask",
         "proton": f"{study_root}/proton.dcm"},
        {"id": "s1", "xenon": f"{study_root}/xenon.dcm",
         "mask": f"{study_root}/mask"},
        {"id": "bad", "xenon": "/nonexistent.dcm", "mask": "/nope"},
    ]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    out = str(tmp_path / "cohort")
    seen = []
    real = summary_mod.cohort_summary
    monkeypatch.setattr(summary_mod, "cohort_summary",
                        lambda results: seen.append(list(results))
                        or real(results))
    prof = tmp_path / "prof"
    rc = main(["cohort", "--manifest", mpath, "--out", out, "--batch", "2",
               "--max-defect", "1024", "--device", "cpu", "--profile-dir",
               str(prof)])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report == {"subjects": 3, "valid": 2, "out": out}
    trace = (prof / "trace.json").read_text()   # the pipeline's stages
    for name in ("snr", "n4", "vdp_kmeans", "ci"):
        assert f'"name": "{name}"' in trace, name
    m0 = json.load(open(os.path.join(out, "s0", "metrics.json")))
    m1 = json.load(open(os.path.join(out, "s1", "metrics.json")))
    assert m0["VDP"] == m1["VDP"]
    summ = json.load(open(os.path.join(out, "cohort_summary.json")))
    assert _js(summ) == _js(json.loads(json.dumps(
        jax_cohort_summary(seen[0]))))
    assert summ["failed"] == [{"id": "bad", "error": "decode_failed"}]
    assert summ["metrics"]["VDP"]["n"] == 2
    assert summ["metrics"]["VDP"]["std"] == pytest.approx(0.0)
    assert os.path.exists(os.path.join(out, "cohort_metrics.csv"))

    rc = main(["cohort", "--manifest", mpath, "--out", out,
               "--device", "cpu"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["valid"] == 2
    summ = json.load(open(os.path.join(out, "cohort_summary.json")))
    assert summ["metrics"]["VDP"]["n"] == 2 and summ["valid"] == 2
    assert _js(summ) == _js(json.loads(json.dumps(
        jax_cohort_summary(seen[1]))))


def test_cli_without_a_card_stops(study_root, tmp_path, capsys):
    """The default device without a card: an error and exit 2, nothing
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mpath = str(tmp_path / "m.json")
    json.dump([{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                "mask": f"{study_root}/mask"}], open(mpath, "w"))
    out = tmp_path / "out"
    assert main(["cohort", "--manifest", mpath, "--out", str(out)]) == 2
    assert "no CUDA card" in capsys.readouterr().err
    (tmp_path / "inbox").mkdir()
    assert main(["serve", "--inbox", str(tmp_path / "inbox"), "--out",
                 str(out), "--once"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
    assert not out.exists()


def test_cli_info(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["ventjax_torch"] == "0.1.0"
    assert info["torch"] == torch.__version__
    assert isinstance(info["devices"], list)
    assert info["default_config"]["ci_max_defect_voxels"] == 8192


def test_cli_commands_and_left_out_flags():
    sub = next(a for a in build_parser()._actions
               if a.dest == "cmd")
    assert sorted(sub.choices) == ["analyze", "cohort", "doctor", "export",
                                   "gui", "info", "serve", "train-seg",
                                   "twix"]
    analyze = ["analyze", "--xenon", "x", "--mask", "m", "--out", "o"]
    auto = build_parser().parse_args(
        ["analyze", "--xenon", "x", "--proton", "p", "--out", "o",
         "--auto-mask", "--seg-ckpt", "c", "--seg-base", "8"])
    assert auto.mask is None and auto.auto_mask
    assert (auto.seg_ckpt, auto.seg_base) == ("c", 8)
    ts = build_parser().parse_args(["train-seg", "--out", "o"])
    assert (ts.steps, ts.batch, tuple(ts.shape), ts.base, ts.seed, ts.lr,
            ts.params_only, ts.plain_phantoms, ts.device) == (
        200, 8, (128, 128, 16), 16, 0, 1e-3, False, False, "cuda")
    for argv in (["cohort", "--manifest", "m", "--out", "o",
                  "--dense-export"],
                 ["--no-compile-cache", "info"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)
    cohort = ["cohort", "--manifest", "m", "--out", "o"]
    assert build_parser().parse_args(cohort + ["--shard-export"]).shard_export
    assert not build_parser().parse_args(cohort).shard_export
    for argv in (["serve", "--inbox", "i", "--out", "o"], analyze,
                 ["export", "--pickle", "p", "--out", "o"],
                 ["twix", "--dat", "d", "--out", "o"], ["gui"]):
        assert build_parser().parse_args(argv).device == "cuda"


def test_cli_parses_shard_slices_and_no_mesh():
    """analyze --shard-slices N|auto, cohort and serve --no-mesh, as
    ventjax's parser takes them."""
    from ventjax.cli import build_parser as jax_parser

    analyze = ["analyze", "--xenon", "x", "--mask", "m", "--out", "o"]
    for argv, key in ((analyze + ["--shard-slices", "2"], "shard_slices"),
                      (analyze + ["--shard-slices", "auto"], "shard_slices"),
                      (analyze, "shard_slices"),
                      (["cohort", "--manifest", "m", "--out", "o",
                        "--no-mesh"], "no_mesh"),
                      (["cohort", "--manifest", "m", "--out", "o"],
                       "no_mesh"),
                      (["serve", "--inbox", "i", "--out", "o", "--no-mesh"],
                       "no_mesh"),
                      (["serve", "--inbox", "i", "--out", "o"], "no_mesh")):
        got = getattr(build_parser().parse_args(argv), key)
        assert got == getattr(jax_parser().parse_args(argv), key), argv


def test_cli_mesh_is_opt_in():
    """cohort and serve take the batch mesh only with --mesh, which
    --no-mesh excludes."""
    for cmd in (["cohort", "--manifest", "m", "--out", "o"],
                ["serve", "--inbox", "i", "--out", "o"]):
        assert not build_parser().parse_args(cmd).mesh
        assert build_parser().parse_args(cmd + ["--mesh"]).mesh
        with pytest.raises(SystemExit):
            build_parser().parse_args(cmd + ["--mesh", "--no-mesh"])


def test_cli_analyze_shard_slices(study_root, tmp_path, capsys,
                                  monkeypatch):
    """analyze --shard-slices auto over two CPU shards (the port's device
    list replaced) prints the one-device run's metrics on a 16-slice study;
    more shards than devices, a halo wider than a shard (the 8-slice study
    at the default rmax 50, whose halo is 8 slices) and a non-integer count
    exit 2 with the reason."""
    from ventjax_torch.dist import mesh

    pytest.importorskip("PIL")
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)
    deep = str(tmp_path / "deep")
    write_study(deep, shape=(32, 32, 16), vox=(1.5, 1.5, 10.0), seed=6)

    def argv(root, out, *extra):
        return ["analyze", "--xenon", f"{root}/xenon.dcm", "--mask",
                f"{root}/mask", "--device", "cpu", "--out",
                str(tmp_path / out), *extra]

    got = {}
    for tag, extra in (("one", ()), ("auto", ("--shard-slices", "auto"))):
        assert main(argv(deep, tag, *extra)) == 0
        got[tag] = json.loads(capsys.readouterr().out)
    assert got["auto"] == got["one"] and got["one"]["DefectVolume"] > 0
    for root, extra, why in (
            (deep, ("--shard-slices", "3"), "exceeds the 2 visible"),
            (study_root, ("--shard-slices", "2"), "too thin to shard"),
            (deep, ("--shard-slices", "two"), "integer or 'auto'")):
        assert main(argv(root, "x", *extra)) == 2
        assert why in capsys.readouterr().err


@pytest.mark.parametrize("spec", ["128x128x16@2.0,2.0,11.5", "64x64x8",
                                  "32X32X4@1,1,1"])
def test_parse_geometry_spec_matches_ventjax(spec):
    assert parse_geometry_spec(spec) == jax_parse_geometry_spec(spec)


@pytest.mark.parametrize("bad", ["64x64", "0x64x8", "64x64x8@1.5,1.5",
                                 "64x64x8@0,1,1", "64x64x8@nan,1.5,10.0",
                                 "64x64x8@inf,1.5,10.0", "sixtyfour"])
def test_parse_geometry_spec_errors(bad):
    with pytest.raises(ValueError, match="bad geometry spec"):
        parse_geometry_spec(bad)


def test_cli_serve_bad_prewarm_spec(tmp_path, capsys):
    (tmp_path / "inbox").mkdir()
    rc = main(["serve", "--inbox", str(tmp_path / "inbox"), "--out",
               str(tmp_path / "o"), "--once", "--prewarm", "garbage",
               "--device", "cpu"])
    assert rc == 2
    assert "geometry spec" in capsys.readouterr().err


# ---------------------------------------------------------------- summary

def _row(sid, vdp, ci=5.0, valid=True, **extra):
    r = {"id": sid, "valid": valid, "SNR": 12.0, "VDP": vdp, "VDP_lb": vdp / 2,
         "VDP_km": vdp / 3, "LungVolume": 4.0, "DefectVolume": 0.1, "CI": ci,
         "CI_saturated_voxels": 0, "CI_overflow": False, "N4_overflow": False}
    r.update(extra)
    return r


SUMMARY_CASES = {
    "stats": [_row(f"s{i}", float(v)) for i, v in enumerate(
        np.random.default_rng(0).uniform(2.0, 30.0, size=17))],
    "failed_and_flagged": [
        _row("ok1", 10.0), _row("ok2", 20.0, CI_overflow=True),
        _row("sat", 30.0, CI_saturated_voxels=4),
        {"id": "dead", "valid": False, "error": "decode_failed"},
        {"id": "ghost", "resumed": True}],
    "nan_ci": [_row("a", 10.0, ci=4.0), _row("b", 0.0, ci=float("nan"))],
    "single": [_row("only", 7.5)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_cohort_summary_matches_ventjax(case):
    rows = SUMMARY_CASES[case]
    got, want = cohort_summary(rows), jax_cohort_summary(rows)
    assert _js(got) == _js(want)


def test_cohort_summary_stats_match_numpy():
    rows = SUMMARY_CASES["stats"]
    vdps = np.array([r["VDP"] for r in rows])
    m = cohort_summary(rows)["metrics"]["VDP"]
    assert m["n"] == 17
    assert m["mean"] == pytest.approx(np.mean(vdps))
    assert m["std"] == pytest.approx(np.std(vdps))
    assert m["p5"] == pytest.approx(np.percentile(vdps, 5))
    assert m["p95"] == pytest.approx(np.percentile(vdps, 95))
    ci = cohort_summary(SUMMARY_CASES["nan_ci"])["metrics"]["CI"]
    assert ci["n"] == 1 and ci["nan"] == 1 and math.isfinite(ci["std"])


# ------------------------------------------------- segmentation: --auto-mask

@pytest.fixture(scope="module")
def seg_study(tmp_path_factory):
    """make_phantom(seed=77) at 128x128x16, written as a study (the
    fixed-generator phantom plants defects; its proton contrast lies in
    the randomized training family), and its hand-mask analysis."""
    from ventjax_torch.io.phantom import make_phantom

    root = tmp_path_factory.mktemp("seg_study")
    write_study(str(root), phantom=make_phantom(
        shape=(128, 128, 16), vox=(1.5, 1.5, 10.0), seed=77))
    return str(root)


def _analyze(capsys, root, out, extra):
    rc = main(["analyze", "--xenon", f"{root}/xenon.dcm", "--out", out,
               "--no-ci", "--device", "cpu"] + extra)
    captured = capsys.readouterr()
    return rc, (json.loads(captured.out) if rc == 0 else None), captured.err


def test_cli_auto_mask_close_to_hand_mask(seg_study, tmp_path, capsys):
    """analyze --auto-mask on the CPU: within 2.0 pp of the hand-mask VDP
    and 12 % of its lung volume (tests/test_automask.py's bounds), the QC
    verdict reported, and the mask analysed equal to ventjax's
    predict_mask on the same proton DICOM."""
    pytest.importorskip("PIL")
    from ventjax.io.dicom import open_single_dicom
    from ventjax.models.segmentation import (
        SegUNet, default_checkpoint_path, load_checkpoint, predict_mask,
    )
    from ventjax_torch.report.export import load_npz

    rc, hand, _ = _analyze(capsys, seg_study, str(tmp_path / "hand"),
                           ["--mask", f"{seg_study}/mask"])
    assert rc == 0 and "automask_suspect" not in hand
    rc, auto, _ = _analyze(capsys, seg_study, str(tmp_path / "auto"),
                           ["--proton", f"{seg_study}/proton.dcm",
                            "--auto-mask", "--npz", "--filename", "a"])
    assert rc == 0
    assert abs(hand["VDP"] - auto["VDP"]) < 2.0, (hand["VDP"], auto["VDP"])
    assert abs(hand["LungVolume"] - auto["LungVolume"]) \
        / hand["LungVolume"] < 0.12
    assert auto["automask_suspect"] is False and auto["automask_qc"] == ""
    _, proton = open_single_dicom(f"{seg_study}/proton.dcm")
    want = np.asarray(predict_mask(
        SegUNet(base=16), load_checkpoint(default_checkpoint_path()).params,
        proton.astype(np.float32)))
    got = load_npz(str(tmp_path / "auto" / "a.npz"))["mask"]
    assert np.array_equal(np.asarray(got, np.float32), want)


def test_cli_auto_mask_argument_errors(seg_study, tmp_path, capsys):
    """ventjax's wording and exit 2: no mask source, --auto-mask without
    --proton; an orbax directory as --seg-ckpt names the converter; a
    --seg-base the checkpoint was not trained at stops the run."""
    from ventjax_torch.models.segmentation import default_checkpoint_path

    out = tmp_path / "out"
    cases = [
        ([], "provide --mask FOLDER or --auto-mask (with --seg-ckpt)"),
        (["--auto-mask"], "--auto-mask needs --proton"),
        (["--proton", f"{seg_study}/proton.dcm", "--auto-mask",
          "--seg-ckpt", os.path.join(os.path.dirname(os.path.dirname(
              os.path.abspath(__file__))), "ventjax", "models", "seg_ckpt")],
         "convert_seg_ckpt.py"),
        (["--proton", f"{seg_study}/proton.dcm", "--auto-mask",
          "--seg-ckpt", str(tmp_path / "absent.npz")],
         "--auto-mask needs --seg-ckpt"),
        (["--proton", f"{seg_study}/proton.dcm", "--auto-mask",
          "--seg-ckpt", default_checkpoint_path(), "--seg-base", "8"],
         "--seg-base 8 does not match"),
    ]
    for extra, message in cases:
        rc, _, err = _analyze(capsys, seg_study, str(out), extra)
        assert rc == 2 and message in err, (extra, err)
    assert not out.exists()


def test_cli_train_seg_then_auto_mask(seg_study, tmp_path, capsys):
    """train-seg on the CPU writes the port's checkpoint; analyze
    --seg-ckpt reads it at its width."""
    pytest.importorskip("PIL")
    ck = tmp_path / "ck"
    rc = main(["train-seg", "--device", "cpu", "--steps", "2", "--batch",
               "2", "--shape", "32", "32", "4", "--base", "4", "--out",
               str(ck)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[0].startswith("step 1/2: loss ")
    report = json.loads(lines[-1])
    assert report["checkpoint"] == str(ck / "seg_ckpt.npz")
    assert report["steps"] == 2 and math.isfinite(report["final_loss"])
    with np.load(report["checkpoint"]) as z:
        assert int(z["step"]) == 2 and int(z["opt_state/count"]) == 2
    rc, got, err = _analyze(capsys, seg_study, str(tmp_path / "auto"),
                            ["--proton", f"{seg_study}/proton.dcm",
                             "--auto-mask", "--seg-ckpt", str(ck),
                             "--seg-base", "4"])
    assert rc == 0, err
    assert isinstance(got["automask_suspect"], bool)
    assert isinstance(got["automask_qc"], str)


def test_cli_empty_auto_mask_stops(seg_study, tmp_path, capsys):
    """A checkpoint that predicts no lung: exit 2 before any analysis or
    export (where the reference package fails in its report's crop)."""
    from ventjax_torch.models import segmentation as tseg

    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=(32, 32), base=4, device="cpu")
    with torch.no_grad():
        state.model.head.bias.fill_(-100.0)
    ck = tseg.save_checkpoint(str(tmp_path / "empty.npz"), state)
    out = tmp_path / "out"
    rc, _, err = _analyze(capsys, seg_study, str(out),
                          ["--proton", f"{seg_study}/proton.dcm",
                           "--auto-mask", "--seg-ckpt", ck, "--seg-base",
                           "4"])
    assert rc == 2 and "predicted an empty lung mask" in err
    assert not out.exists()


def test_cli_segmentation_without_a_card_stops(seg_study, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    rc = main(["train-seg", "--steps", "1", "--out", str(tmp_path / "ck")])
    assert rc == 2 and "no CUDA card" in capsys.readouterr().err
    rc = main(["analyze", "--xenon", f"{seg_study}/xenon.dcm", "--proton",
               f"{seg_study}/proton.dcm", "--auto-mask", "--out",
               str(tmp_path / "o")])
    assert rc == 2 and "no CUDA card" in capsys.readouterr().err
    assert not (tmp_path / "ck").exists() and not (tmp_path / "o").exists()
