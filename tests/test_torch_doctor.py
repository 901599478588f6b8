"""ventjax_torch's deployment self-check (utils/doctor.py) on the CPU.

With ``device="cpu"`` every required check passes (the pipeline self-test
holds the port's analyze_study to the oracle within 0.1 pp, as
tests/test_doctor.py holds ventjax's); checks are isolated; and the default
device without a card reports failure and never runs on the CPU.
"""
import json

import pytest
import torch

from ventjax_torch.cli import main
from ventjax_torch.utils import doctor

NAMES = ["versions", "backend", "device_probe", "kernel_build",
         "native_scanner", "seg_checkpoint", "codec_roundtrip",
         "pipeline_selftest"]


@pytest.fixture(scope="module")
def cpu_report():
    return doctor.run_doctor(device="cpu")


def test_run_doctor_cpu_all_required_ok(cpu_report):
    report = cpu_report
    assert report["ok"] is True and report["full"] is False
    assert [c["name"] for c in report["checks"]] == NAMES
    for c in report["checks"]:
        if c["required"]:
            assert c["ok"], c
    json.dumps(report)   # the report is plain JSON
    by = {c["name"]: c for c in report["checks"]}
    assert not by["kernel_build"]["required"]   # the CPU runs no kernel
    st = by["pipeline_selftest"]
    assert st["device"] == "cpu" and st["shape"] == [32, 32, 8]
    assert st["dvdp_pp"] < doctor.VDP_TOLERANCE_PP
    assert by["device_probe"]["result"] == 28
    assert by["backend"]["backend"] == "cpu"


def test_seg_checkpoint_present_and_loads(cpu_report):
    """The shipped --auto-mask artifact: present, loaded (step 800, base
    16) and run on the check's device; optional, as in the reference."""
    from ventjax_torch.models.segmentation import default_checkpoint_path

    by = {c["name"]: c for c in cpu_report["checks"]}
    seg = by["seg_checkpoint"]
    assert seg["ok"] and not seg["required"]
    assert seg["present"] and seg["path"] == default_checkpoint_path()
    assert (seg["step"], seg["base"], seg["device"]) == (800, 16, "cpu")


def test_check_isolation(monkeypatch):
    """An induced crash in one required check fails the report, and every
    other check still runs and reports."""
    def boom(device):
        raise RuntimeError("induced")

    monkeypatch.setattr(doctor, "_device_probe", boom)
    monkeypatch.setattr(doctor, "_pipeline_selftest",
                        lambda full, device: {"dvdp_pp": 0.0})
    report = doctor.run_doctor(device="cpu")
    assert report["ok"] is False
    by = {c["name"]: c for c in report["checks"]}
    assert not by["device_probe"]["ok"]
    assert "induced" in by["device_probe"]["error"]
    assert by["codec_roundtrip"]["ok"] and by["pipeline_selftest"]["ok"]
    assert by["versions"]["ok"] and by["backend"]["ok"]


def test_backend_on_a_card_keeps_the_check_name(monkeypatch):
    """On a CUDA device the backend check reports the card's name under its
    own key, so the report's check name stays "backend"."""
    monkeypatch.setattr(doctor, "_dev", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    c = doctor._check("backend", True, lambda: doctor._backend("cuda"))
    assert c["name"] == "backend" and c["ok"]
    assert c["card"] == "NVIDIA H100 80GB HBM3" and c["device_count"] == 1


def test_default_device_without_a_card_fails(monkeypatch):
    """Without a card the default device fails backend, device_probe and
    the self-test, and analyses nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import ventjax_torch.pipeline as tp

    calls = []
    monkeypatch.setattr(tp, "analyze_study",
                        lambda *a, **k: calls.append(a))
    report = doctor.run_doctor()
    assert report["ok"] is False
    by = {c["name"]: c for c in report["checks"]}
    for name in ("backend", "device_probe", "pipeline_selftest"):
        assert not by[name]["ok"] and by[name]["required"]
        assert "no CUDA card" in by[name]["error"], by[name]
    assert by["kernel_build"]["required"]
    assert calls == []


def test_cli_doctor(capsys):
    rc = main(["doctor", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"]


def test_cli_doctor_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    rc = main(["doctor"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and not report["ok"]
