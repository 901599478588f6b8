"""The reader of K10's resident warps (``metrics/tail_resident_warps.py``)
on hand-built counters: warps over launches, and None where the program
has no such counter or launched no K10."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests._tiny import ROOT


def _read(counts):
    return harness.load_reader(ROOT, "tail_resident_warps")(
        SimpleNamespace(counts=counts))


@pytest.mark.parametrize("warps, launches, want", [
    (64, 2, 32.0), (96, 3, 32.0), (8, 1, 8.0), (0, 4, 0.0)])
def test_warps_over_launches(warps, launches, want):
    got = _read({"tail_balls": launches, "tail_balls_resident_warps": warps,
                 "head_counts": 5, "alias_min_d2_rows": 4096})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"tail_balls": 2, "alias_min_d2_rows": 4096},   # the parent's counters
    {"tail_balls": 0, "tail_balls_resident_warps": 0},
    {}])
def test_none_without_the_counter_or_a_launch(counts):
    assert _read(counts) is None
