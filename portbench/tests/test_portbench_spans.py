"""The readers of the program's spans and CI row counters
(``metrics/n4_iter_launch_us.py``, ``n4_iter_wait_us.py``,
``kmeans_syncs_per_call.py``, ``host_syncs_per_call.py``,
``ci_row_use.py``) on a hand-built traced window with known answers, and
None where the program has no such span or counter."""
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, harness
from portbench.tests._tiny import ROOT

NAMES = ("n4_iter_launch_us", "n4_iter_wait_us", "kmeans_syncs_per_call",
         "host_syncs_per_call", "ci_row_use")
# Two traced calls in a window of 0-1000 us; the spans before it belong to
# the session's warm-up call and are not read.
HOST = [
    ("portbench.call", 0, 500), ("portbench.call", 500, 1000),
    ("n4", 50, 480), ("n4.level", 90, 460),
    ("n4.iter", 100, 200), ("n4.sharpen", 100, 150), ("n4.fit", 150, 180),
    ("n4.sync", 180, 200),
    ("n4.iter", 300, 450), ("n4.sync", 420, 450),
    ("vdp_kmeans.sync", 600, 610), ("vdp_kmeans.sync", 700, 705),
    ("vdp_kmeans.sync", 800, 801), ("ci.sync", 900, 902),
    ("portbench.d2h", 950, 990),
    ("n4.iter", -400, -300), ("n4.sync", -310, -300),
    ("vdp_kmeans.sync", -200, -190), ("ci.sync", -100, -90),
]


def _ctx(host=HOST, counts=None, calls=(0, 1, 1)):
    defect = {0: torch.zeros(2, 8, 8, 2), 1: torch.zeros(2, 8, 8, 2)}
    defect[0].view(-1)[:100] = 1
    defect[1].view(-1)[:156] = 1
    worked = []

    def work(b):
        worked.append(b)
        return {"defect": defect[b]}

    trace = devtrace.Trace(window=(0.0, 1000.0), device=[], host=list(host))
    return SimpleNamespace(
        trace=trace, calls=list(calls), studies=2 * len(calls),
        counts={"head_counts": 3, "head_counts_rows": 2048,
                "alias_min_d2_rows": 512} if counts is None else counts,
        work=work, worked=worked)


def _read(name, ctx):
    return harness.load_reader(ROOT, name)(ctx)


def test_n4_iteration_launch_and_wait():
    ctx = _ctx(calls=(0, 1))
    # iterations 100 + 150 us, their waits 20 + 30 us
    assert _read("n4_iter_launch_us", ctx) == pytest.approx((250 - 50) / 2)
    assert _read("n4_iter_wait_us", ctx) == pytest.approx(50 / 2)


def test_syncs_per_call():
    ctx = _ctx(calls=(0, 1))
    assert _read("kmeans_syncs_per_call", ctx) == pytest.approx(3 / 2)
    # two n4.sync, three vdp_kmeans.sync, one ci.sync
    assert _read("host_syncs_per_call", ctx) == pytest.approx(6 / 2)


def test_ci_row_use_reads_each_batch_once():
    ctx = _ctx()
    # calls on batches 0, 1, 1: 100 + 156 + 156 defect voxels
    assert _read("ci_row_use", ctx) == pytest.approx(
        100.0 * 412 / (2048 + 512))
    assert sorted(ctx.worked) == [0, 1]


@pytest.mark.parametrize("name", NAMES)
def test_none_where_the_program_has_nothing(name):
    # the parent program: its six stages and HOST_SYNCS, no span below a
    # stage, no row counter
    stages = [h for h in HOST if "." not in h[0] or h[0].startswith(
        "portbench")]
    ctx = _ctx(host=stages, counts={"head_counts": 3, "n4_host_syncs": 98})
    assert _read(name, ctx) is None
    assert ctx.worked == []


@pytest.mark.parametrize("name", ["n4_iter_launch_us", "n4_iter_wait_us"])
def test_n4_readers_need_both_spans(name):
    no_sync = [h for h in HOST if h[0] != "n4.sync"]
    assert _read(name, _ctx(host=no_sync)) is None


def test_rows_without_defects_read_zero():
    ctx = _ctx(calls=(0,))
    ctx.work = lambda b: {"defect": torch.zeros(2, 8, 8, 2)}
    assert _read("ci_row_use", ctx) == 0.0
