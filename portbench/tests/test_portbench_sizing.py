"""Set-up sizes the CI pad as the cohort driver grows it, call batch by
call batch at the cell's own size, and keeps each batch's output at the
final pads; a run then reads its repeats against those outputs."""
import json

import pytest

from portbench import harness
from portbench.tests._tiny import make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cell with defects that overflow the driver's first bucket."""
    root = make_root(tmp_path_factory.mktemp("sizing"))
    path = root / "portbench/traffic/tiny.json"
    mix = json.loads(path.read_text())
    mix["phantom"].update(n_defects=8, defect_radius_vox=[5.0, 6.0, 8.0])
    path.write_text(json.dumps(mix))
    return root


def test_ci_pad_grows_from_the_first_bucket(root):
    cell = harness.Cell(harness.load_cell(root, "tiny.cell"), 5, "cpu")
    counts = [int((o["defect"] != 0).reshape(cell.bs, -1).sum(1).max())
              for o in cell.outputs.values()]
    pad = cell.cfg.ci_max_defect_voxels
    assert sorted(cell.outputs) == list(range(cell.n_batches))
    assert max(counts) > harness.CI_PAD_FIRST
    assert pad >= max(counts) and pad & (pad - 1) == 0
    assert pad < 2 * max(counts) or pad == harness.CI_PAD_FIRST
    assert not any(bool(o["metrics"]["ci_overflow"].any())
                   for o in cell.outputs.values())
    n4_pad = cell.cfg.n4_mask_pad
    assert n4_pad % harness.N4_PAD_STEP == 0
    assert n4_pad - harness.N4_PAD_STEP < int((cell.mask > 0).reshape(
        cell.mask.shape[0] * cell.bs, -1).sum(1).max()) <= n4_pad


def test_run_at_grown_pads_repeats_set_up(root, capsys):
    rc, res, _ = run_tiny(root, capsys, seed=5)
    assert rc == 0 and res["correct"] is True
    assert res["checks"]["repeat_diff"]["value"] == 0
