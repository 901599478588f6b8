"""A configuration, a traffic mix, a per-layer metric and a cell are added
as new files and new entries of BENCHMARK.json, with no file edited."""
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

from portbench import harness
from portbench.tests._tiny import DATA, ROOT, make_root, run_tiny

PROBE = '''"""A metric added as a file: the measured window's calls."""


def read(ctx):
    return float(ctx.window_calls)
'''


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for d in DATA for p in (root / "portbench" / d).rglob("*")
            if p.is_file()}


def test_added_files_are_found_and_nothing_is_edited(tmp_path, capsys):
    root = make_root(tmp_path)
    (root / "portbench/metrics/calls_in_window.py").write_text(PROBE)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": "studies_per_s", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    before = _digests(ROOT)
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        Path("portbench/configs/tiny.json"),
        Path("portbench/traffic/tiny.json"),
        Path("portbench/metrics/calls_in_window.py")}

    spec = harness.load_cell(root, "tiny.cell")
    assert spec.config["shape"] == [64, 64, 8]
    assert spec.traffic["studies_per_call"] == 2
    names = [m["name"] for m in harness.cell_metrics(bench, "tiny.cell",
                                                     True)]
    assert "calls_in_window" in names
    assert "calls_in_window" not in [m["name"] for m in harness.cell_metrics(
        bench, "clinical.cohort16", True)]
    read = harness.load_reader(root, "calls_in_window")
    assert read(SimpleNamespace(window_calls=7)) == 7.0

    rc, res, _ = run_tiny(root, capsys, seed=8)
    assert rc == 0 and res["correct"] is True
