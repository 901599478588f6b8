"""The kernels' work counts against counts made by hand at small shapes."""
import itertools
import json

import pytest
import torch

from portbench import devtrace
from portbench.kernels import work
from portbench.peaks import PEAK_BYTES, PEAK_F32, least_seconds
from portbench.reference.geometry import alias_combos
from portbench.tests._tiny import ROOT
from ventjax_torch.ops.n4 import _bspline_rows

SPEC = {k: json.loads((ROOT / f"portbench/kernels/{k}.json").read_text())
        for k in ("fit_moment", "fit_delta_conv_field", "head_counts")}


@pytest.mark.parametrize("n,n_el", [(8, 1), (16, 2), (17, 4), (128, 8)])
def test_nnz_per_coord_counts_the_spline_rows(n, n_el):
    # the port's basis rows in float64: 3 non-zeros where the parameter is
    # whole, else 4
    rows = _bspline_rows(torch.arange(n, dtype=torch.float64)[None], n, n_el)
    want = (rows[0] != 0).sum(1).double()
    assert torch.equal(work.nnz_per_coord(n, n_el, "cpu"), want)


def test_lane_terms_by_hand():
    w = torch.zeros(1, 5, 5, 3)
    w[0, 0, 0, 0] = w[0, 2, 4, 1] = w[0, 3, 1, 2] = 1
    (t,) = work.lane_terms(w, 1, 4)
    nr, nc, ns = (work.nnz_per_coord(n, 1, "cpu") for n in (5, 5, 3))
    pts = [(0, 0, 0), (2, 4, 1), (3, 1, 2)]
    assert float(t["n"][0]) == 3
    assert float(t["k1"][0]) == sum(nr[h] * nc[x] * ns[s] for h, x, s in pts)
    assert float(t["k2"][0]) == sum(nr[h] * nc[x] * ns[s] + nr[h] * nc[x]
                                    + nr[h] for h, x, s in pts)


def _terms(n):
    return [{"ncp": 4, "n": torch.tensor([float(n), float(n)]),
             "k1": torch.tensor([64.0 * n, 64.0 * n]),
             "k2": torch.tensor([84.0 * n, 84.0 * n])}]


def test_fit_moment_by_hand():
    # one level, lane 0 iterating 2 times and lane 1 once: the
    # denominator over both lanes, then 2 lanes, then 1
    b = {"terms": _terms(1000), "iters": torch.tensor([[2], [1]])}
    per_lane = least_seconds(1000 * 13 * 4 + 64 * 4, 2 * 64000)
    two = least_seconds(2 * (1000 * 13 * 4 + 64 * 4), 2 * 128000)
    assert work.fit_moment(b, SPEC["fit_moment"]) == pytest.approx(
        two + two + per_lane)
    assert per_lane == pytest.approx((1000 * 13 * 4 + 256) / PEAK_BYTES)


def test_fit_delta_conv_field_by_hand():
    b = {"terms": _terms(1000), "iters": torch.tensor([[2], [1]])}
    one = least_seconds(1000 * 17 * 4 + 68 * 4, 2 * 84000)
    two = least_seconds(2 * (1000 * 17 * 4 + 68 * 4), 2 * 168000)
    assert work.fit_delta_conv_field(b, SPEC["fit_delta_conv_field"]) == \
        pytest.approx(two + one)


@pytest.mark.parametrize("rmax", [1, 2, 5])
def test_box_distances_by_pairs(rmax):
    g = torch.Generator().manual_seed(rmax)
    d = (torch.rand((2, 7, 6, 3), generator=g) > 0.7).float()
    got = work.box_distances(d, rmax)
    for n in range(2):
        v = torch.nonzero(d[n]).tolist()
        want = sum(all(abs(w[a] - c[a] + s[a]) <= rmax for a in range(3))
                   for c, w in itertools.product(v, v)
                   for s in alias_combos((7, 6, 3)))
        assert float(got[n]) == want


def test_head_counts_by_hand():
    d = torch.zeros(1, 4, 4, 2)
    d[0, 0, 0, 0] = d[0, 3, 3, 1] = 1
    b = {"defect": d, "rmax": 50, "n_balls": 40}
    # every (center, witness) pair lies in the box under all 9 shifts
    assert work.head_counts(b, SPEC["head_counts"]) == pytest.approx(
        least_seconds(2 * (24 + 39 * 4), 8 * 4 * 9))
    assert PEAK_F32 == 67e12


def test_trace_busy_union_and_gaps():
    tr = devtrace.Trace(window=(0.0, 100.0),
                        device=[("void moment_partial<4>(float*)", 10, 20),
                                ("k", 15, 30), ("k", 50, 60),
                                ("late", 95, 125)],
                        host=[("portbench.call", 0, 100), ("n4", 30, 50)])
    assert tr.busy() == [(10, 30), (50, 60), (95, 100)]
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.device_seconds(["moment_partial"]) == (pytest.approx(1e-5), 1)
    gaps = dict(tr.idle_gaps())
    assert gaps["n4"] == pytest.approx(20e-6)
    assert gaps["portbench.call"] == pytest.approx(45e-6)
    assert tr.top_ops()[0] == ["late", pytest.approx(30e-6)]
