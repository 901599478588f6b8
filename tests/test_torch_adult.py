"""The adult deployment (256x256x16 at 1.5x1.5x10 mm, 188,304 lung
voxels, the CI pad at 32,768) on the port's normal path, on the CPU.

- The fused pipeline against the benchmark's plain float64 reference
  (``portbench/reference/pipeline.py``) on seeded studies of the adult
  mix at a reduced geometry: the mix's defect share, the pads grown as the
  benchmark grows them (``portbench/harness.py:Cell``), then the tail at
  the pad's width, where the adult cell ends; each number within the adult
  configuration's ``fidelity`` limits.  At this size every row resolves in
  K3's head (no voxel lies deeper than its 96 balls, 11.56 mm), so the
  tail runs sentinel rows only; the tail's live rows are held to the
  reference at the adult size by the benchmark itself.
- N4's pad sized from the lung by the cohort driver and the facade, for a
  lung over 65,536 voxels, with a caller's ``n4_mask_pad`` kept as a cap
  unless it is the default (65,536, which caps nothing there, passed or
  not): the sizing alone, with the analysis stubbed out.
- K3's ``head_counts_triples`` counter on the CPU route.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.compare import judge
from portbench.generate import lung_mask
from ventjax_torch.compat import Vent_Analysis
from ventjax_torch.config import DEFAULT_CONFIG, N4_PAD_STEP, n4_pad_for
from ventjax_torch.ops import ci_cuda
from ventjax_torch.pipeline import cohort as tc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ADULT = json.loads((ROOT / "portbench/configs/adult_256x256x16.json")
                   .read_text())
MIX = json.loads((ROOT / "portbench/traffic/moderate.b16.pool32.json")
                 .read_text())
SHAPE, VOX = tuple(ADULT["shape"]), tuple(ADULT["vox"])
V = int(np.prod(SHAPE))
LUNG = 188_304                     # make_phantom's lobes at the adult shape
SMALL = (96, 96, 8)                # the adult geometry, 3/8 in-plane, 1/2 deep


class _Stop(Exception):
    pass


def _small_cell(seed):
    """The adult configuration and mix at SMALL: the defect radii scaled
    with the matrix (so the defect share is about the mix's), two studies
    a call, the CI ceiling scaled with the lung (2,048: 15 % of it, where
    32,768 is 17 % of the adult lung)."""
    conf = json.loads(json.dumps(ADULT))
    conf.update(shape=list(SMALL))
    conf["pipeline"].update(ci_max_defect_voxels=2048)
    mix = json.loads(json.dumps(MIX))
    scale = SMALL[0] / SHAPE[0]
    mix["phantom"]["defect_radius_vox"] = [
        r * scale for r in MIX["phantom"]["defect_radius_vox"]]
    mix.update(studies_per_call=2, pool_studies=4)
    return harness.Cell(SimpleNamespace(config=conf, traffic=mix), seed,
                        "cpu")


@pytest.fixture(scope="module")
def small_cell():
    return _small_cell(11)


def test_small_adult_cell_grows_its_pads(small_cell):
    cell = small_cell
    lung = int((cell.mask[0, 0] > 0).sum())
    counts = [int((o["defect"] != 0).reshape(cell.bs, -1).sum(1).max())
              for o in cell.outputs.values()]
    # about the mix's defect share (9-14 % at the adult size)
    assert 0.06 < max(counts) / lung < 0.2
    assert cell.cfg.n4_mask_pad == -(-lung // N4_PAD_STEP) * N4_PAD_STEP
    assert harness.CI_PAD_FIRST < max(counts) <= cell.cfg.ci_max_defect_voxels
    assert cell.cfg.ci_max_defect_voxels == 2048
    assert not any(bool(o["metrics"]["ci_overflow"].any()
                        or o["metrics"]["n4_overflow"].any())
                   for o in cell.outputs.values())


@pytest.mark.parametrize("batch,tail_full", [(0, False), (1, True)])
def test_small_adult_cell_against_the_reference(small_cell, batch,
                                                tail_full):
    cell = small_cell
    limits = {k: v for k, v in ADULT["fidelity"].items()
              if not k.startswith("_")}
    base = cell.cfg
    if tail_full:
        cell._set_pads(base, base.ci_max_defect_voxels, True)
    try:
        before = ci_cuda.LAUNCHES["alias_min_d2_rows"]
        out = cell.call(batch)[0]
        tail_rows = ci_cuda.LAUNCHES["alias_min_d2_rows"] - before
    finally:
        cell._set_pads(base, base.ci_max_defect_voxels, False)
    assert tail_rows == cell.bs * (2048 if tail_full else 256)
    ok, rows = judge([(cell.hp[batch], cell.mask[batch], out,
                       cell.outputs[batch])], cell.vox, cell.pipe, limits,
                     "cpu")
    assert ok, rows


@pytest.mark.parametrize("cap,want", [
    (None, 188_416),               # the default: the lung, to 8,192
    (DEFAULT_CONFIG.n4_mask_pad, 188_416),
    (4096, 4096),                  # a caller's pad stays a cap
    (196_608, 188_416),
    (2 * V, 188_416),
])
def test_n4_pad_for_an_adult_lung(cap, want):
    cfg = DEFAULT_CONFIG if cap is None else DEFAULT_CONFIG.replace(
        n4_mask_pad=cap)
    assert n4_pad_for(cfg, LUNG, V) == want
    assert n4_pad_for(cfg, 1, V) == min(N4_PAD_STEP, want)
    assert n4_pad_for(DEFAULT_CONFIG, V, V) == V


def _adult_lung():
    return lung_mask(SHAPE, "cpu").numpy()


@pytest.mark.parametrize("cap,want", [
    (None, 188_416),
    (65_536, 188_416),             # the default, given: no cap, as stated
    (65_535, 65_535),
    (65_536 + N4_PAD_STEP, 65_536 + N4_PAD_STEP),
])
def test_driver_sizes_n4_from_an_adult_lung(monkeypatch, cap, want):
    """run_cohort's runner takes an adult lung whole at the defaults (and
    with --max-defect 32768), also where the caller passes the default
    n4_mask_pad itself; a caller's other, smaller n4_mask_pad caps it, and
    the overflow flag then stands: no retry grows past the cap."""
    seen = {}

    def stub(hp, mask, geom, cfg, export_compact=True):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(tc, "analyze_cohort", stub)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=32768)
    if cap is not None:
        cfg = cfg.replace(n4_mask_pad=cap)
    lung = _adult_lung()
    assert int(lung.sum()) == LUNG
    runner = tc._GeometryRunner(SHAPE, VOX, cfg, 2, device="cpu")
    study = (np.zeros(SHAPE, np.float32), lung.astype(np.uint8), VOX, None,
             None)
    with pytest.raises(_Stop):
        runner.dispatch([({"id": "a"}, study), ({"id": "b"}, study)])
    capped = want < 188_416
    assert runner.n4_bucket == seen["cfg"].n4_mask_pad == want
    assert seen["cfg"].ci_max_defect_voxels == 512
    # an N4 overflow at a caller's cap stands; without one the pad may
    # still grow to the volume
    assert runner.bump_for_retry(False, True, (512, want, False)) is (
        not capped)
    assert runner.n4_bucket == (want if capped else min(2 * want, V))


@pytest.mark.parametrize("cap,want", [
    (None, 188_416), (65_536, 188_416), (65_535, 65_535)])
def test_facade_sizes_n4_from_an_adult_lung(monkeypatch, cap, want):
    seen = {}

    def stub(self, hp, mask, mask_pad=None):
        seen["pad"] = mask_pad
        raise _Stop

    monkeypatch.setattr(Vent_Analysis, "_n4", stub)
    lung = _adult_lung()
    cfg = DEFAULT_CONFIG if cap is None else DEFAULT_CONFIG.replace(
        n4_mask_pad=cap)
    v = Vent_Analysis(xenon_array=lung * 100.0, mask_array=lung,
                      config=cfg, device="cpu")
    v.vox = VOX
    with pytest.raises(_Stop):
        v.calculate_VDP()
    assert seen["pad"] == want


@pytest.mark.parametrize("combos", [1, 9])
def test_head_counts_triples_on_the_cpu_route(combos):
    gen = torch.Generator().manual_seed(combos)
    N, K, Kw = 2, 40, 24

    def coords(n):
        return tuple(torch.randint(0, 12, (N, n), generator=gen,
                                   dtype=torch.int32) for _ in range(3))

    shifts = [(0, 0, 0)] + [(p, q, 0) for p in (-1, 1) for q in (-1, 1)] \
        + [(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0)]
    before = dict(ci_cuda.LAUNCHES)
    counts = ci_cuda.head_counts(coords(K), coords(Kw),
                                 torch.tensor([1.0, 4.0, 9.0]),
                                 shifts[:combos], (1.0, 1.0, 1.0), 6)
    got = {k: v - before[k] for k, v in ci_cuda.LAUNCHES.items()}
    assert counts.shape == (N, K, 3)
    assert got["head_counts_triples"] == N * K * Kw * combos
    assert got["head_counts_rows"] == N * K
    assert got["head_counts"] == 0             # the CPU runs no kernel
