"""The port's spans and counters (``utils/profiling.stage`` and
``host_wait``, the spans inside N4, k-means and the CI engine, the CI
engine's row counters), on the CPU.

Off (no profiler session on the thread) a span is the one shared null
context and builds no RecordFunction; under a CPU ``torch.profiler``
session ``analyze_cohort`` emits every span of the contract, nested as
named, with one ``n4.sync`` a ``HOST_SYNCS["n4"]`` count and one
``vdp_kmeans.sync`` a Lloyd iteration, and gives the same bits as with
the profiler off.
"""
import collections
import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.dist import make_batch_space_mesh, spatial_shard_fn
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.ops import ci_cuda, n4
from ventjax_torch.ops.ci_pairwise import calculate_ci_pairwise
from ventjax_torch.pipeline import analyze_cohort, build_geometry
from ventjax_torch.utils import profiling

torch.set_num_threads(2)
SHAPE, VOX = (64, 64, 8), (1.5, 1.5, 10.0)
CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
MAPS = ("n4", "defect", "defect_lb", "defect_km", "defect_border", "ci_map")
# Every span a call of analyze_cohort emits, and the span that holds it.
PARENT = {
    "n4.compact": "n4", "n4.level": "n4", "n4.iter": "n4.level",
    "n4.sharpen": "n4.iter", "n4.fit": "n4.iter", "n4.sync": "n4.iter",
    "n4.field": "n4", "vdp_kmeans.init": "vdp_kmeans",
    "vdp_kmeans.iter": "vdp_kmeans", "vdp_kmeans.sync": "vdp_kmeans.iter",
    "vdp_kmeans.assign": "vdp_kmeans", "ci.coords": "ci", "ci.head": "ci",
    "ci.tail": "ci", "ci.densify": "ci",
}


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.is_user_annotation]


def _holder(spans, span):
    """The innermost other span that holds ``span``."""
    name, s, e = span
    holders = [h for h in spans if h is not span and h[1] <= s and e <= h[2]
               and (h[2] - h[1]) >= (e - s)]
    return min(holders, key=lambda h: h[2] - h[1])[0] if holders else None


Runs = collections.namedtuple("Runs", "off on spans n4_syncs ci_counts")


@pytest.fixture(scope="module")
def runs():
    """analyze_cohort on 2 x 64x64x8, with the profiler off and on: (off
    result, on result, the session's spans, HOST_SYNCS and CI row
    deltas of the traced call)."""
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=0)
    hp, mask = torch.from_numpy(hp), torch.from_numpy(mask)
    geom = build_geometry(VOX, SHAPE, CFG)
    off = analyze_cohort(hp, mask, geom, CFG)
    syncs, rows = n4.HOST_SYNCS["n4"], dict(ci_cuda.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = analyze_cohort(hp, mask, geom, CFG)
    return Runs(off, on, _spans(prof), n4.HOST_SYNCS["n4"] - syncs,
                {k: v - rows[k] for k, v in ci_cuda.LAUNCHES.items()})


def test_spans_off_are_the_shared_null_context(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a RecordFunction was built with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    for ctx in (profiling.stage("n4.iter"), profiling.host_wait("n4.sync")):
        assert ctx is profiling._OFF
        with ctx:
            pass
    hp, mask, _ = make_cohort(1, (32, 32, 8), VOX, seed=1)
    cfg = CFG.replace(ci_max_defect_voxels=256, n4_fitting_levels=2,
                      n4_max_iters=5)
    analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask),
                   build_geometry(VOX, (32, 32, 8), cfg), cfg)


def test_spans_on_are_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("a"):
            with profiling.host_wait("a.sync"):
                pass
    names = [s[0] for s in _spans(prof)]
    assert names.count("a") == 1 and names.count("a.sync") == 1


@pytest.mark.parametrize("child", sorted(PARENT))
def test_pipeline_spans_nest(runs, child):
    spans = runs.spans
    mine = [s for s in spans if s[0] == child]
    assert mine, f"no {child} span"
    assert {_holder(spans, s) for s in mine} == {PARENT[child]}


def test_stage_spans_once_a_call(runs):
    counts = collections.Counter(s[0] for s in runs.spans)
    for name in ("snr", "n4", "vdp_mean_anchored", "vdp_linear_binning",
                 "vdp_kmeans", "ci", "n4.compact", "n4.field",
                 "vdp_kmeans.init", "vdp_kmeans.assign", "ci.coords",
                 "ci.head", "ci.tail", "ci.densify"):
        assert counts[name] == 1, name
    assert counts["n4.level"] == CFG.n4_fitting_levels
    # the CI engine's five numpy tables, each a pageable upload
    assert counts["ci.sync"] == 5


def test_n4_sync_spans_are_the_host_syncs(runs):
    counts = collections.Counter(s[0] for s in runs.spans)
    assert runs.n4_syncs > 0
    assert counts["n4.sync"] == runs.n4_syncs
    for name in ("n4.iter", "n4.sharpen", "n4.fit"):
        assert counts[name] == runs.n4_syncs, name


def test_kmeans_syncs_one_a_lloyd_iteration(runs):
    counts = collections.Counter(s[0] for s in runs.spans)
    assert 1 <= counts["vdp_kmeans.iter"] <= CFG.kmeans_iters
    assert counts["vdp_kmeans.sync"] == counts["vdp_kmeans.iter"]


def test_pipeline_row_counters(runs):
    # K = 1024, tail default max(256, K // 8) = 256, two lanes
    assert runs.ci_counts["head_counts_rows"] == 2 * 1024
    assert runs.ci_counts["alias_min_d2_rows"] == 2 * 256
    assert runs.ci_counts["head_counts"] == 0      # the CPU runs no kernel


@pytest.mark.parametrize("K, tail_k, K2", [(256, 64, 64), (256, None, 256),
                                           (512, 1024, 512)])
def test_ci_row_counters_at_a_known_pad(K, tail_k, K2):
    gen = np.random.default_rng(K)
    defect = torch.from_numpy(
        (gen.random((3, 32, 32, 8)) < 0.02).astype(np.float32))
    geom = build_geometry(VOX, (32, 32, 8), CFG.replace(ci_rmax=12))
    before = dict(ci_cuda.LAUNCHES)
    calculate_ci_pairwise(defect, geom, K, tail_k=tail_k)
    got = {k: v - before[k] for k, v in ci_cuda.LAUNCHES.items()}
    assert got == {"head_counts": 0, "head_counts_rows": 3 * K,
                   "head_counts_triples": 3 * K * K * 9,
                   "alias_min_d2_rows": 3 * K2, "tail_balls": 0}


def test_outputs_bit_identical_with_the_profiler_on(runs):
    for name in MAPS:
        assert torch.equal(getattr(runs.off, name), getattr(runs.on, name)), \
            name
    for name, v in vars(runs.off.metrics).items():
        w = getattr(runs.on.metrics, name)
        assert torch.equal(v.isnan(), w.isnan()), name
        assert torch.equal(v.nan_to_num(), w.nan_to_num()), name


@pytest.mark.parametrize("raises", [False, True])
def test_host_wait_restores_the_sync_debug_mode(monkeypatch, raises):
    state = {"mode": 2, "seen": []}
    monkeypatch.setattr(profiling, "_get_sync_mode", lambda: state["mode"])
    monkeypatch.setattr(profiling, "_set_sync_mode",
                        lambda m: state.update(mode=m))
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with profiling.host_wait("ci.sync"):
            state["seen"].append(state["mode"])
            if raises:
                raise RuntimeError("inside")
    assert state["seen"] == [0] and state["mode"] == 2
    state["mode"] = 0
    assert profiling.host_wait("ci.sync") is profiling._OFF


def test_space_axis_n4_spans():
    hp, mask, _ = make_cohort(1, (32, 32, 8), VOX, seed=2)
    cfg = CFG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                      n4_fitting_levels=2, n4_max_iters=10)
    geom = build_geometry(VOX, (32, 32, 8), cfg)
    fn = spatial_shard_fn(functools.partial(analyze_cohort, geom=geom,
                                            config=cfg),
                          make_batch_space_mesh(1, 2, devices=["cpu"] * 2))
    syncs = n4.HOST_SYNCS["n4"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(torch.from_numpy(hp), torch.from_numpy(mask))
    spans = _spans(prof)
    counts = collections.Counter(s[0] for s in spans)
    assert counts["n4.level"] == 2
    assert counts["n4.sync"] == counts["n4.iter"] == (
        n4.HOST_SYNCS["n4"] - syncs) > 0
    for child in ("n4.iter", "n4.sync", "n4.level"):
        assert {_holder(spans, s) for s in spans if s[0] == child} == {
            PARENT[child]}, child
