"""The adult configuration, its mix and its cell: they load, the cell
sizes its pads from the pool alone (N4 188,416; CI 32,768), and the K3
box-use metric reads a share on a tiny cell, and nothing where the program
has no triple counter."""
import math
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.generate import make_studies
from portbench.tests._tiny import ROOT, make_root

CELL = "adult.moderate16"


@pytest.fixture(scope="module")
def spec():
    return harness.load_cell(ROOT, CELL)


def test_adult_cell_loads(spec):
    c, t = spec.config, spec.traffic
    assert spec.cell["chips"] == 1
    assert c["name"] == "adult_256x256x16" and c["reduced"] == []
    assert c["shape"] == [256, 256, 16] and c["vox"] == [1.5, 1.5, 10.0]
    assert c["pipeline"]["ci_max_defect_voxels"] == 32768
    clinical = harness.load_json(
        ROOT / "portbench/configs/clinical_128x128x16.json")
    assert c["guarantees"] == clinical["guarantees"]
    assert {k: v for k, v in c["pipeline"].items()
            if k != "ci_max_defect_voxels"} == clinical["pipeline"]
    assert (t["studies_per_call"], t["pool_studies"], t["sample_calls"]) \
        == (16, 32, 2)
    names = {m["name"] for m in harness.cell_metrics(spec.bench, CELL, True)}
    # every per-layer metric but the collectives', which one card has not
    assert names == {m["name"] for m in spec.bench["per_layer"]
                     if m["layer"] != "collectives"}
    assert "head_box_use" in names


def test_adult_cell_sizes_its_pads_from_the_pool(spec):
    """The harness's rules on the pool's masks and planted defects: the N4
    pad covers the lung in steps of 8,192, and every call batch needs the
    CI ceiling (its largest defect count is over half of it)."""
    c, t = spec.config, spec.traffic
    shape, bs = tuple(c["shape"]), t["studies_per_call"]
    hp, mask = make_studies(t["pool_studies"], shape, tuple(c["vox"]), 19,
                            "cpu", **t["phantom"])
    lung = (mask > 0).reshape(mask.shape[0], -1).sum(1)
    V = math.prod(shape)
    n4 = min(V, -(-int(lung.max()) // harness.N4_PAD_STEP)
             * harness.N4_PAD_STEP)
    assert int(lung.max()) == 188_304 and n4 == 188_416
    # a planted defect is the signal times 0.08, far below 0.6 of the mean
    planted = ((hp < 0.3 * t["phantom"]["signal_level"]) & (mask > 0))
    counts = planted.reshape(-1, bs, V).sum(2).max(1).values
    top = c["pipeline"]["ci_max_defect_voxels"]
    for n in counts.tolist():
        assert top // 2 < n <= top
        need = 1 << math.ceil(math.log2(n))
        assert min(top, max(2 * harness.CI_PAD_FIRST, need)) == 32768


def test_head_box_use_reads_a_share_on_a_tiny_cell(tmp_path):
    root = make_root(tmp_path)
    cell = harness.Cell(harness.load_cell(root, "tiny.cell"), 4, "cpu")
    c0 = harness._counters()
    cell.call(0)
    cell.call(1)
    counts = harness._delta(c0, harness._counters())
    work = {b: {"defect": cell.outputs[b]["defect"],
                "rmax": int(cell.pipe["ci_rmax"])} for b in (0, 1)}
    read = harness.load_reader(root, "head_box_use")
    ctx = SimpleNamespace(calls=[0, 1], counts=counts, work=work.__getitem__)
    # the triples come from the shapes: two calls' N x K x Kw x 9 combos
    K = cell.cfg.ci_max_defect_voxels
    assert counts["head_counts_triples"] == 2 * cell.bs * K * K * 9
    assert 0.0 < read(ctx) <= 100.0
    # the parent's program has no triple counter: nothing to read
    assert read(SimpleNamespace(calls=[0], counts={},
                                work=work.__getitem__)) is None
