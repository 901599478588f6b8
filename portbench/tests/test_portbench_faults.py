"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the tiny cell on the CPU), each fault
the cell can have planted after set-up, in the window's calls, each caught
by the number that reads it.  (The cells run on one card: there is no
exchange between cards to leave out.)"""
import pytest
import torch

import ventjax_torch.pipeline.analyze as A
from portbench.tests._tiny import make_root, run_tiny


def n4_state_unchanged(monkeypatch):
    """N4 hands back the image it was given (its state unchanged)."""
    real = A.n4_bias_correction

    def broken(image, mask, **kw):
        n4, ovf, (idx, _, wv) = real(image, mask, **kw)
        raw = image.reshape(image.shape[0], -1).gather(1, idx)
        return image.to(torch.float32), ovf, (idx, raw, wv)
    monkeypatch.setattr(A, "n4_bias_correction", broken)


def half_batch_left_out(cell):
    """Only the first half of each batch is analysed; the other half gets
    the first half's maps and, for its metrics, their mean."""
    real = cell.analyze_cohort

    def broken(hp, mask, geom, cfg):
        h = hp.shape[0] // 2
        res = real(hp[:h], mask[:h], geom, cfg)
        for k in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
                  "ci_map"):
            x = getattr(res, k)
            setattr(res, k, torch.cat([x, x]))
        for k, v in vars(res.metrics).items():
            fill = v.float().mean(0, keepdim=True).to(v.dtype).expand_as(v)
            setattr(res.metrics, k, torch.cat([v, fill]))
        return res
    cell.analyze_cohort = broken


def ci_answer_altered(cell):
    """One defect voxel's CI value altered where it is produced."""
    real = cell.analyze_cohort

    def broken(hp, mask, geom, cfg):
        res = real(hp, mask, geom, cfg)
        v = torch.nonzero(res.defect[0])[0]
        res.ci_map[0][tuple(v)] += 0.015
        return res
    cell.analyze_cohort = broken


def vdp_answer_altered(cell):
    """One study's VDP reported 0.2 percentage points high."""
    real = cell.analyze_cohort

    def broken(hp, mask, geom, cfg):
        res = real(hp, mask, geom, cfg)
        res.metrics.vdp[1] += 0.2
        return res
    cell.analyze_cohort = broken


def repeat_not_bitwise(cell):
    """Each study's SNR one float32 step high: within its limit, but not
    the bits set-up produced for the same batch."""
    real = cell.analyze_cohort

    def broken(hp, mask, geom, cfg):
        res = real(hp, mask, geom, cfg)
        snr = res.metrics.snr
        res.metrics.snr = torch.nextafter(snr, torch.full_like(snr, 1e30))
        return res
    cell.analyze_cohort = broken


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("fault,caught_by", [
    (n4_state_unchanged, "n4_rel"), (half_batch_left_out, "snr_rel"),
    (ci_answer_altered, "ci_map_mm"), (vdp_answer_altered, "vdp_pp"),
    (repeat_not_bitwise, "repeat_diff")])
def test_fault_is_not_correct(root, capsys, monkeypatch, fault, caught_by):
    if fault is n4_state_unchanged:
        breaker = lambda cell: fault(monkeypatch)
    else:
        breaker = fault
    rc, res, err = run_tiny(root, capsys, seed=21, breaker=breaker)
    assert rc == 0
    assert res["correct"] is False
    failed = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert caught_by in failed, res["checks"]
    # set-up ran the program unbroken, so every fault differs from it too
    assert "repeat_diff" in failed


def test_sound_run_of_the_same_seed_is_correct(root, capsys):
    rc, res, _ = run_tiny(root, capsys, seed=21)
    assert rc == 0 and res["correct"] is True
