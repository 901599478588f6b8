"""The reader of N4's graph replays (``metrics/n4_graph_use.py``) on
hand-built counters: replays over iterations, and None where the program
has no replay counter or ran no iteration."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests._tiny import ROOT


def _read(counts):
    return harness.load_reader(ROOT, "n4_graph_use")(
        SimpleNamespace(counts=counts))


@pytest.mark.parametrize("replays, syncs, want", [
    (98, 98, 100.0), (94, 98, 100.0 * 94 / 98), (0, 49, 0.0)])
def test_replays_over_iterations(replays, syncs, want):
    got = _read({"n4_host_syncs": syncs, "n4_iter_graph_replays": replays,
                 "n4_iter_graph_captures": 0, "fit_moment": 106})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"n4_host_syncs": 98, "fit_moment": 106},     # the parent's counters
    {"n4_host_syncs": 0, "n4_iter_graph_replays": 0},
    {}])
def test_none_without_replays_or_iterations(counts):
    assert _read(counts) is None
